"""Multi-device latency mode of the PyTorch/CUDA port: ``OMG(mesh=...)``
over rank processes.

The counterpart of ``examples/multichip_latency.py``. The JAX example
shards one program over 8 virtual devices; the port runs one process per
rank (``parallel.launch.spawn``), each holding the same weights, joined
by ``torch.distributed``:
  * stage 1 spatially split: the two CFG lanes over the mesh's data axis,
    the latent's rows over its model axis (the sequence-sharded flash
    kernel, K1b, where a level splits);
  * stage 2 lane-parallel: the 4 + 2K lanes spread over every rank.

``make_latency_mesh(N)`` lays the ranks out as (data, model) = (2, N/2)
when N is even: 8 ranks give JAX's (2, 4) grid. With ``--device cuda``
rank r takes card r mod the card count; ranks that share a card talk
through gloo. Tiny random weights, so it runs anywhere:

    python examples/torch_multichip_latency.py --ranks 8 --device cpu

On cards with real weights, use the CLIs: ``omg-torch-serve --mesh 8`` /
``omg-torch-lora --mesh 8``.
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from omg_tpu_torch.parallel import launch, mesh as mesh_lib
from omg_tpu_torch.pipelines import omg, sdxl
from omg_tpu_torch.text.tokenizer import ToyTokenizer

PROMPT = "photo of the man and woman"
REWRITE = "[the chris man]-*-[ugly]|[the taylor woman]-*-[ugly]"
STEPS = 4


def demo_mask_provider(image, cls):
    """Stand-in for the SAM detector (segment.build_mask_provider): left
    half = first concept, right half = second."""
    m = np.zeros(image.shape[:2], np.float32)
    if cls == "man":
        m[:, : image.shape[1] // 2] = 1.0
    else:
        m[:, image.shape[1] // 2:] = 1.0
    return m


def engine(device, mesh=None) -> omg.OMG:
    """The tiny engine with weights from seed 0 (the same on every rank;
    the mesh engine checks that), on ``device``."""
    cfg = sdxl.tiny_config()    # real use: loader.load_sdxl(checkpoint)
    params = sdxl.init_params(torch.Generator("cpu").manual_seed(0), cfg,
                              "cpu")
    params = sdxl.SDXLParams(*(m.to(device) for m in params))
    return omg.OMG(cfg=cfg, params=params, tokenizer=ToyTokenizer(),
                   tokenizer_2=ToyTokenizer(),
                   mask_provider=demo_mask_provider, num_steps=STEPS,
                   mesh=mesh)


def generate(eng: omg.OMG):
    with torch.inference_mode():
        return eng.generate(PROMPT, prompt_rewrite=REWRITE, seed=14,
                            height=32, width=32)


def rank_main(rank: int, device, n: int) -> dict:
    """One rank: the latency mesh over the n-rank world, then generate."""
    mesh = mesh_lib.make_latency_mesh(n, device=device)
    res = generate(engine(device, mesh))
    return {"grid": (mesh.data, mesh.model), "stage1": res.stage1,
            "stage2": res.stage2, "image": res.image}


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, default=8)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    devices, backend = launch.mesh_devices(args.ranks, args.device,
                                           "multichip example")
    ranks = launch.spawn(rank_main, args.ranks, backend=backend,
                         devices=devices, args=(args.ranks,), timeout=600)
    out = ranks[0]
    print(f"{args.ranks} ranks over {backend}, (data, model) = "
          f"{out['grid']}: stage1 {out['stage1'].shape}, stage2 "
          f"{None if out['stage2'] is None else out['stage2'].shape}, "
          f"image {out['image'].shape}, every rank the same image: "
          f"{all(np.array_equal(r['image'], out['image']) for r in ranks)}")
    return ranks


if __name__ == "__main__":
    main()
