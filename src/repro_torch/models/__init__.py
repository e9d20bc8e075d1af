"""The LM scaffold of the port: attention-only decoder models for serving."""
