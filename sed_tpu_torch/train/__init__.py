"""Training: loss, optimizer, state, checkpoints and the train loop."""
