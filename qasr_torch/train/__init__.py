"""Training for the port: optimizer and state, the step, the loop."""
