"""Training: losses, the reference's AdamW and Adafactor, the train step
with gradient accumulation, checkpoints of named trees, and fault
tolerance (injected failures, restarts, serve-side chaos hooks)."""
