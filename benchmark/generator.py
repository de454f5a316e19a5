"""The one traffic generator: a mix's parameters -> the run's requests.

A mix is a data file ``traffic/<mix>.json``. Every seed gets the same
sizes (canvas, images per request, concept count, masks); the seed draws
only what a user varies: the words of each prompt and each request's
noise seed. So two seeds ask the program for the same work.

Keys: ``arrivals`` ("closed_loop": one client, the next request sent when
the last returns), ``requests`` (how many the run draws, more than a
window holds), ``prompt_words``, ``negative_words`` and ``region_words``
([least, most] words per prompt), ``concepts`` (region prompts per
request), ``images_per_request``, ``vocabulary`` (the word pool),
``masks`` (per concept a box [x0, y0, x1, y1] as fractions of the
canvas, or absent).
"""

from __future__ import annotations

import json
import pathlib
from typing import List

import numpy as np

from benchmark.weights import STREAMS, stream_seed

ROOT = pathlib.Path(__file__).resolve().parent


def load_mix(name: str, root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "traffic" / f"{name}.json").read_text())


def _words(rng: np.random.Generator, pool: list, bounds: list) -> str:
    n = int(rng.integers(bounds[0], bounds[1] + 1))
    return " ".join(pool[i] for i in rng.integers(0, len(pool), n))


def requests(mix: dict, seed: int) -> List[dict]:
    """The run's requests in order: each a dict of ``index``, ``seed``
    (its noise seed), ``prompt``, ``negative``, ``regions`` [(prompt,
    negative), ...] and ``images``."""
    if mix["arrivals"] != "closed_loop":
        raise ValueError(f"arrivals {mix['arrivals']!r}: only closed_loop")
    rng = np.random.default_rng(stream_seed(seed, STREAMS["noise"], 1))
    pool = mix["vocabulary"]
    out = []
    for i in range(mix["requests"]):
        regions = [(_words(rng, pool, mix["region_words"]),
                    _words(rng, pool, mix["negative_words"]))
                   for _ in range(mix.get("concepts", 0))]
        out.append(dict(
            index=i, seed=stream_seed(seed, STREAMS["noise"], 2 + i),
            prompt=_words(rng, pool, mix["prompt_words"]),
            negative=_words(rng, pool, mix["negative_words"]),
            regions=regions, images=mix["images_per_request"]))
    return out


def box_masks(mix: dict, h: int, w: int) -> np.ndarray:
    """[K, h, w] 0/1 masks of the mix's boxes at h x w."""
    boxes = mix.get("masks", [])
    m = np.zeros((len(boxes), h, w), np.float32)
    for k, (x0, y0, x1, y1) in enumerate(boxes):
        m[k, round(y0 * h):round(y1 * h), round(x0 * w):round(x1 * w)] = 1
    return m
