"""The plain reference that decides ``correct``: PyTorch and numpy only.

It imports nothing of the port (``repro_torch``), of the JAX package
(``repro``) or of JAX. It reads the weights the benchmark made, the
router's trained parameters (the port's state, which it recomputes
nothing from but the scores), and the port's outputs only to judge them.
"""
