"""The ``prompt_rewrite`` mini-DSL.

Grammar (reference: inference_lora.py:128-149 ``prepare_text`` and the
3-field InstantID variant at inference_instantid.py:233-254):

    [region prompt]-*-[region negative]                        (LoRA)
    [region prompt]-*-[region negative]-*-<ref image path>     (InstantID)

regions joined by '|'. Square brackets are cosmetic and stripped.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

SEP = "-*-"


@dataclasses.dataclass(frozen=True)
class Region:
    prompt: str
    negative_prompt: str
    ref_image: Optional[str] = None


def parse_rewrite(prompt_rewrite: str) -> List[Region]:
    regions = []
    for chunk in prompt_rewrite.split("|"):
        if chunk == "":
            continue    # skip empty chunks (trailing '|' or a '||' typo)
                        # without dropping the regions after them
        fields = chunk.split(SEP)
        if len(fields) == 2:
            p, n = fields
            ref = None
        elif len(fields) == 3:
            p, n, ref = fields
            ref = ref.replace("[", "").replace("]", "").strip()
        else:
            raise ValueError(
                f"prompt_rewrite region needs 2 or 3 '-*-' fields, got "
                f"{len(fields)}: {chunk!r}")
        strip = lambda s: s.replace("[", "").replace("]", "")
        regions.append(Region(strip(p), strip(n), ref))
    return regions
