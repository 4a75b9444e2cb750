"""Training: loss, Adam step and epoch loops, the CV driver, metrics."""
