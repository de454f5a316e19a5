"""The port's serving and fidelity tools (counterparts of ``tools/``).

  * ``serve_bench``: the two-concept workload through the real
    ``OMGServer`` over HTTP, against the engine's own measured ceiling.
  * ``soak_bench``: mixed-class concurrent requests against one server,
    each storm image held against its own serial baseline.
  * ``fidelity_harness``: the weight-free self-check of the harness and
    its metrics (PSNR, SSIM, LPIPS when installed).

Each runs on the card unless the caller passes ``--device cpu``.
"""
