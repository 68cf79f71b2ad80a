"""Routed serving: the router in front of the model pool."""
