"""The program's side of each model family (benchmark/family.py)."""
