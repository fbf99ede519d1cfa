"""Training loop pieces: the optimizer and the train/eval steps."""
