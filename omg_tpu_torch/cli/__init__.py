"""The reference's command-line entry points on the port:
``python -m omg_tpu_torch.cli.inference_lora``,
``python -m omg_tpu_torch.cli.inference_instantid`` and the server,
``python -m omg_tpu_torch.cli.serve``."""
