"""Measurement tools of the port, each run as `python -m
dgcnn_tpu_torch.tools.<name>`: one JSON line on stdout (an `{"error": ...}`
object on failure), detail on stderr."""
