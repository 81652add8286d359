"""hello_tpu_torch — the PyTorch / CUDA port of hello_tpu for NVIDIA Hopper.

The package keeps hello_tpu's layout and module names, so every module has its
counterpart at the same relative path.  Host modules that never used JAX
(io, reads, counts, assembly, featurize, window, native, sim and the host
half of pipeline/) are byte-identical copies; the modules that used JAX are
rewritten in torch:

  hello_tpu_torch.nn        — config-driven torch networks, MoE model,
                              weight bridge from hello_tpu parameters, decode
  hello_tpu_torch.ops       — the hand-written CUDA read-convolver kernel
  hello_tpu_torch.pipeline  — wire expansion on the device, Scorer, calling

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.  The
port imports neither ``jax`` nor any module of ``hello_tpu``.
"""

__version__ = "0.1.0"
