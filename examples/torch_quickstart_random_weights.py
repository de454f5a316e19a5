"""Zero-checkpoint quickstart of the PyTorch/CUDA port: the full OMG
two-stage flow with random weights.

The counterpart of ``examples/quickstart_random_weights.py`` for
``omg_tpu_torch``: stage 1 with prompt-to-prompt control, the mask
provider on the stage-1 image, stage 2's region fusion with a LoRA per
concept, at the tiny geometry. The weights are random, so the image
means nothing; the point is every API in one runnable file, with no
checkpoint to download. It runs on the card, or on the CPU with
``--device cpu`` (a few seconds).

    python examples/torch_quickstart_random_weights.py [--device cpu]
"""

import argparse
import pathlib
import sys

# runnable straight from a source checkout (no install needed)
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from omg_tpu_torch.nn import layers
from omg_tpu_torch.pipelines import omg, sdxl
from omg_tpu_torch.text.tokenizer import ToyTokenizer
from omg_tpu_torch.utils import image


def left_right_masks(img, cls):
    """Stand-in mask provider: 'man' owns the left half, 'woman' the
    right (real deployments use segment.build_mask_provider('sam', ...))."""
    m = np.zeros(img.shape[:2], np.float32)
    half = img.shape[1] // 2
    if cls == "man":
        m[:, :half] = 1.0
    else:
        m[:, half:] = 1.0
    return m


def random_lora(seed, dim, device, rank=4):
    """A rank-4 LoRA on the mid block's cross-attention query, in the
    port's flat form {module path: {"down", "up", "scale"}}."""
    g = torch.Generator("cpu").manual_seed(seed)
    leaf = {"down": torch.randn(dim, rank, generator=g) * 0.05,
            "up": torch.randn(rank, dim, generator=g) * 0.05,
            "scale": torch.tensor(1.0)}
    return {"mid_block.attentions.0.transformer_blocks.0.attn2.to_q":
            {k: v.to(device) for k, v in leaf.items()}}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--out", default="quickstart.png",
                   help="where to write the final image ('' for nowhere)")
    args = p.parse_args(argv)
    device = layers.target_device(args.device, "quickstart")

    cfg = sdxl.tiny_config()
    with torch.inference_mode():
        params = sdxl.init_params(torch.Generator(device).manual_seed(0),
                                  cfg, device)
        # Serving knobs (all optional): scheduler="lcm" + num_steps=8 for
        # the few-step mode, concept_crop=True for strip-cropped concept
        # lanes, cache_interval=3 for DeepCache, quantize="int8", mesh=...
        # for the multi-device layout (examples/torch_multichip_latency.py).
        engine = omg.OMG(cfg=cfg, params=params, tokenizer=ToyTokenizer(),
                         tokenizer_2=ToyTokenizer(),
                         mask_provider=left_right_masks, num_steps=4)
        dim = cfg.unet.block_out_channels[-1]
        result = engine.generate(
            "photo of the man and the woman at the beach",
            prompt_rewrite="[photo of the man]-*-[ugly]|"
                           "[photo of the woman]-*-[ugly]",
            concept_loras=[random_lora(1, dim, device),
                           random_lora(2, dim, device)],
            seed=14, height=32, width=32)

    print("stage-1 image:", result.stage1.shape, result.stage1.dtype)
    print("final image:  ", result.image.shape, result.image.dtype)
    print("masks found:  ", [m is not None for m in result.masks])
    print("seconds:      ", result.timings)
    if args.out:
        image.write_png(args.out, result.image)
        print("wrote", args.out)
    return result


if __name__ == "__main__":
    main()
