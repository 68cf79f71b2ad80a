"""Dual-predictor routing: the attention predictor, rewards, the router."""
