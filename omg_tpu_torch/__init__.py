"""omg_tpu_torch — the OMG engine in PyTorch and CUDA for one NVIDIA H100.

The port of ``omg_tpu`` (JAX/XLA/Pallas on a TPU), which stays beside it
as the reference every module is tested against. The package imports
torch and never jax. Its layout mirrors ``omg_tpu``: each module is the
counterpart of the JAX module at the same path.

Design stance:
  * Models are ``nn.Module``s whose submodule names follow the diffusers /
    transformers state_dicts (the JAX parameter tree mirrors them;
    ``from_jax.py`` moves weights over).
  * LoRA adapters and prompt-to-prompt control are runtime inputs of the
    UNet forward, so one module serves the base lanes and every concept
    lane (``nn/layers.py``).
  * Public functions keep the JAX layouts: latents [B, h, w, 4] NHWC,
    attention [B, H, N, D], masks [K, h, w]. Inside the UNet and the VAE
    the convolutions run NCHW (contiguous, not ``channels_last``).
  * Randomness comes from a seeded ``torch.Generator`` wherever the JAX
    code takes a ``jax.random`` key; the two give different numbers for
    one seed, so cross-package tests pass the noise in (``initial_noise``).
    The seeded draws of a request (initial latents, LCM's re-noise) use a
    CPU generator, so one seed gives one image on any device.
  * Weights load from the reference's own checkpoint files (``loader.py``,
    ``convert.py``, ``lora.py``) without the ``safetensors`` or
    ``transformers`` packages; the CLIs are ``cli/``.
  * The one TPU kernel, flash attention, is CUDA C++ for sm_90a
    (``ops/csrc/flash_attention.cu``), built with nvcc at first use.
"""

__version__ = "0.1.0"
