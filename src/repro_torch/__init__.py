"""PyTorch/CUDA port of :mod:`repro` for NVIDIA Hopper (H100).

The package mirrors ``repro``'s layout and names, so every module here has
a counterpart there; ``repro`` stays the numerical reference. The port
imports ``torch`` and never ``jax``, and nothing of ``repro`` either: what
it needs of ``repro``'s numpy-only modules it keeps as its own copy.

Conventions:
  * weights keep the reference's ``(d_in, d_out)`` layout and apply as
    ``x @ w``, so carrying weights across (:mod:`repro_torch.bridge`) is a
    copy;
  * every initializer takes an explicit ``torch.Generator``, whose device
    is where the parameters are made;
  * entry points run on CUDA unless the caller passes ``device="cpu"``;
    without a device and without a card they raise
    (:func:`repro_torch.common.device.resolve_device`);
  * every TPU (Pallas) kernel on a ported path is a hand-written Hopper
    kernel under ``csrc/``; its plain PyTorch version runs only for
    tensors that lie on the CPU.
"""
