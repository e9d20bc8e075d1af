"""Serving layer of the port: planning, the circuit server, tracing."""
