"""Training: losses, the train state and optimizer, the train step."""
