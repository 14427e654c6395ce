"""Training for the port: AdamW, the train step, and the runtime tables."""
