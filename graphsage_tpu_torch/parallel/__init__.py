"""Training steps and chunk runners (single device for now)."""
