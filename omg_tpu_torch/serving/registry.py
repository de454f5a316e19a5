"""Character and style LoRA registry (port of
``omg_tpu/serving/registry.py``).

Named characters (LoRA path, trigger prompt, negative prompt) and styles
that the server offers as choices. The registry is data the server loads
once; choosing a character per request selects another LoRA delta dict,
with no weight surgery. ``lora_cache(lora.load_lora)`` reads every
registered file once, onto the card by default.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict


@dataclasses.dataclass(frozen=True)
class CharacterSpec:
    name: str
    prompt: str             # region prompt containing the trigger token
    negative_prompt: str
    path: str               # LoRA safetensors path


@dataclasses.dataclass(frozen=True)
class StyleSpec:
    name: str
    path: str


class Registry:
    def __init__(self):
        self.characters_man: Dict[str, CharacterSpec] = {}
        self.characters_woman: Dict[str, CharacterSpec] = {}
        self.styles: Dict[str, StyleSpec] = {}

    def add_character(self, group: str, spec: CharacterSpec):
        target = (self.characters_man if group == "man"
                  else self.characters_woman)
        target[spec.name] = spec

    def add_style(self, spec: StyleSpec):
        self.styles[spec.name] = spec

    @classmethod
    def from_json(cls, path: str) -> "Registry":
        """Load a registry file:
        {"man": [{name, prompt, negative_prompt, path}, ...],
         "woman": [...], "styles": [{name, path}, ...]}
        """
        with open(path) as f:
            data = json.load(f)
        reg = cls()
        for group in ("man", "woman"):
            for item in data.get(group, []):
                reg.add_character(group, CharacterSpec(**item))
        for item in data.get("styles", []):
            reg.add_style(StyleSpec(**item))
        return reg

    def lora_cache(self, lora_loader) -> Dict[str, object]:
        """Preload every registered LoRA once (serving keeps them resident
        as delta dicts instead of re-reading files per request); paths
        that do not exist are left out."""
        cache = {}
        for spec in (list(self.characters_man.values())
                     + list(self.characters_woman.values())):
            if os.path.exists(spec.path):
                cache[spec.name] = lora_loader(spec.path)
        for spec in self.styles.values():
            if os.path.exists(spec.path):
                cache[spec.name] = lora_loader(spec.path)
        return cache


def default_registry() -> Registry:
    """The reference's template layout (4 man + 4 woman characters, 3
    styles) with checkpoint-relative paths; users point these at their
    own LoRA files."""
    reg = Registry()
    entries_man = [
        ("Chris Evans", "Close-up photo of the Chris Evans, 35mm "
         "photograph, professional, 4k, highly detailed.",
         "checkpoint/lora/chris-evans.safetensors"),
        ("Harry Potter", "Close-up photo of the Harry Potter, 35mm "
         "photograph, professional, 4k, highly detailed.",
         "checkpoint/lora/Harry_Potter.safetensors"),
        ("Jordan Torres", "Close-up photo of the jordan_torres man, 35mm "
         "photograph, professional, 4k, highly detailed.",
         "checkpoint/lora/jordan_torres_v2_xl.safetensors"),
        ("Gleb Savchenko", "Close-up photo of the Lecun man, 35mm "
         "photograph, professional, 4k, highly detailed.",
         "checkpoint/lora/gleb_savchenko_sdxl.safetensors"),
    ]
    entries_woman = [
        ("Taylor Swift", "Close-up photo of the TaylorSwift, 35mm "
         "photograph, professional, 4k, highly detailed.",
         "checkpoint/lora/TaylorSwiftSDXL.safetensors"),
        ("Hermione Granger", "Close-up photo of the Hermione Granger, 35mm "
         "photograph, professional, 4k, highly detailed.",
         "checkpoint/lora/Hermione_Granger.safetensors"),
        ("Keira Knightley", "Close-up photo of the kei_kn woman, 35mm "
         "photograph, professional, 4k, highly detailed.",
         "checkpoint/lora/keira_lora_sdxl_v1-000008.safetensors"),
        ("Jennifer Lawrence", "Close-up photo of the Jennifer Lawrence "
         "WOMAN, 35mm photograph, professional, 4k, highly detailed.",
         "checkpoint/lora/lawrence_dh128_v1-step00012000.safetensors"),
    ]
    neg = "noisy, blurry, soft, deformed, ugly"
    for name, prompt, path in entries_man:
        reg.add_character("man", CharacterSpec(name, prompt, neg, path))
    for name, prompt, path in entries_woman:
        reg.add_character("woman", CharacterSpec(name, prompt, neg, path))
    for name, path in [
            ("Cinematic Photography Style",
             "checkpoint/style/Cinematic Hollywood Film.safetensors"),
            ("Anime sketch style",
             "checkpoint/style/Anime_Sketch_SDXL.safetensors"),
            ("Oil Painting Style",
             "checkpoint/style/EldritchPaletteKnife.safetensors")]:
        reg.add_style(StyleSpec(name, path))
    return reg
