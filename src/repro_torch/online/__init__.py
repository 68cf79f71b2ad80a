"""Online layer of the port: so far the drift detector."""
