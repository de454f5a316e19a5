"""Entries: how a cell drives the program, one module per entry, named by
a workload file's ``entry``. Each exports ``setup(ctx)``, ``run(ctx,
state, request)``, ``images(request)``, ``unet_lanes(cfg)``,
``flops(cfg, request)``, ``free(state)``, ``reference_latents(ctx,
request, sds, cast)`` and ``check(ctx, request, output)``."""
