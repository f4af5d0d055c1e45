"""Training of the port: optimizers, the train step, the runner."""
