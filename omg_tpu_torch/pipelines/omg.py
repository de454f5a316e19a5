"""High-level OMG pipeline, the user-facing two-stage engine (port of
``omg_tpu/pipelines/omg.py``).

``OMG.generate`` encodes the prompts, runs stage 1, asks the mask
provider for per-concept masks on the stage-1 image (copy B, uint8), runs
stage 2 with region fusion and decodes. The provider is any callable;
``segment.build_mask_provider`` builds the port's own (SAM over
EfficientViT-SAM or the SAM ViT, optionally with the SAM-proposal x CLIP
detector), whose device work ``timings["masks"]`` covers.

Beside the two-concept LoRA path it takes the JAX signature's
conditioning: a spatial ControlNet on the base lanes of both stages
(``controlnet_params`` with a ready ``spatial_condition`` image, its
scale, guidance window and guess mode; BASELINE config #3) and InstantID
(``InstantIDModels``: the resampler's face tokens through the concept
lanes' IP cross-attention and the IdentityNet on the concept lanes in
stage 2, from ``face_embeddings`` and ``face_kps_image`` or
``face_kps_provider``; config #4), with any of the Euler, DDIM, DPM++2M
and LCM schedulers, on one device or under a mesh.

The approximate modes, opt-in as in JAX: ``quantize="int8"`` (W8A8 on
the UNet's transformer linears, ``ops/quant.py``), ``concept_crop`` (stage
2's concept lanes on vertical strips, where the request allows it) and
DeepCache (``cache_interval``, placed by ``cache_schedule``, per request
in ``generate`` and ``generate_batch``), which composes with the
ControlNets, InstantID and the mesh.

``OMG(mesh=...)`` is the multi-device latency mode: every rank of the
mesh builds the engine over its own copy of the same weights and calls
``generate`` with the same arguments; stage 1 runs spatially split, stage
2 lane-split and the decode H-split (``pipelines/multiconcept.py``), and
every rank returns the same images. A spatial ControlNet runs H-split
beside the UNet in stage 1 and on the ranks that hold base lanes in stage
2; InstantID's IP tokens and IdentityNet run on the ranks that hold
concept lanes, the keypoints drawn from the gathered stage-1 image, which
every rank holds whole.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from omg_tpu_torch import instantid as iid
from omg_tpu_torch import lora as lora_lib
from omg_tpu_torch import rewrite
from omg_tpu_torch.config import ControlNetConfig, ResamplerConfig
from omg_tpu_torch.control import p2p, regions as regions_lib
from omg_tpu_torch.diffusion import schedulers
from omg_tpu_torch.ops import quant
from omg_tpu_torch.parallel import mesh as mesh_lib
from omg_tpu_torch.pipelines import multiconcept, sdxl
from omg_tpu_torch.utils import profiling

# mask_provider(image_uint8 [H, W, 3], class_text) -> [H, W] {0,1} or None
MaskProvider = Callable[[np.ndarray, str], Optional[np.ndarray]]


def seq_splits(cfg: sdxl.SDXLConfig, height: int, n: int) -> bool:
    """Whether stage 1 may split the latent's H over ``n`` ranks: only
    while the deepest UNet level's rows still divide by n, so that every
    stride-2 block starts on an even row. Other canvases (the 832, 1216
    and 1344 buckets on a 4-way axis) take the lane-only layout: the CFG
    lanes over the data axis, H whole."""
    depth = len(cfg.unet.block_out_channels) - 1
    return ((height // 8) >> depth) % n == 0


@dataclasses.dataclass
class GenerationResult:
    stage1: np.ndarray                  # [2, H, W, 3] uint8 (copy A, B)
    stage2: Optional[np.ndarray]        # same, or None if no masks found
    masks: List[Optional[np.ndarray]]   # per-concept pixel masks
    # host-clock seconds per phase ("encode", "stage1", "masks",
    # "stage2", "decode"): the request's phase spans
    # (utils/profiling.Phases), each ended with the device idle
    timings: dict = dataclasses.field(default_factory=dict)

    @property
    def image(self) -> np.ndarray:
        """The deliverable: copy B of the last stage."""
        out = self.stage2 if self.stage2 is not None else self.stage1
        return out[1]


@dataclasses.dataclass
class InstantIDModels:
    """The identity stack: the resampler, the UNet's IP layers (one
    ``nn.attention.IPKV`` per attn2, traversal order) and the IdentityNet
    (a ``models.controlnet.ControlNetModel``), on the engine's device."""
    resampler_cfg: ResamplerConfig
    resampler_params: object            # models.resampler.Resampler
    ip_adapter_layers: Sequence         # [IPKV] in attn2 order
    identitynet_params: Optional[object] = None
    identitynet_cfg: Optional[ControlNetConfig] = None
    ip_scale: float = 0.8
    identitynet_scale: float = 0.8


def _fusion_start(steps: int, fusion_start: Optional[int]) -> int:
    """The reference fuses after step 15 of 50; keep the fraction unless
    the caller gave the step."""
    if fusion_start is not None:
        return fusion_start
    return round(steps * regions_lib.FUSION_START_STEP / 50)


def _given(value) -> bool:
    """A request field that is set: not None and not False (arrays are
    never tested for truth)."""
    return value is not None and value is not False


def _engine_device(engine: "OMG", *args, **kwargs) -> torch.device:
    """The device of a call's request record: the engine's."""
    return engine.device


@dataclasses.dataclass
class OMG:
    """The OMG engine over one SDXL weight set (on the models' device)."""

    cfg: sdxl.SDXLConfig
    params: sdxl.SDXLParams
    tokenizer: object                   # text.tokenizer.Tokenizer (enc 1)
    tokenizer_2: object                 # (enc 2)
    mask_provider: Optional[MaskProvider] = None
    # The geometry of the ControlNets handed to generate (checked against
    # each model's own).
    cn_cfg: Optional[ControlNetConfig] = None
    scheduler: str = "euler"
    num_steps: int = 50
    # Concept-LoRA strength on concept lanes (reference
    # cross_attention_kwargs={'scale': 0.8}).
    concept_lora_scale: float = 0.8
    # set_adapters([char, style], [0.7, 0.5]) mix.
    char_style_weights: tuple = (0.7, 0.5)
    # "int8": W8A8 on the UNet's transformer linears (approximate, opt-in;
    # ops/quant.py); "" keeps the weights as they are.
    quantize: str = ""
    # Approximate, opt-in: stage 2's concept lanes on vertical strips
    # (multiconcept._denoise_cropped_batch). A request with
    # per-concept ControlNets, or whose width does not split, runs exact;
    # generate_batch always runs exact.
    concept_crop: bool = False
    # Approximate, opt-in DeepCache in both stages: a full UNet forward
    # every cache_interval-th step, a shallow one from the cached feature
    # otherwise. 0 or 1 = exact. Exclusive with concept_crop.
    cache_interval: int = 0
    # How the full steps are placed: "uniform" (modulo, phased from each
    # range's start) or "front" (the same count packed towards step 0,
    # the fusion-start step forced full). Per request: "cache_schedule".
    cache_schedule: str = "uniform"
    # Multi-device latency layout: this rank's view of a (data, model)
    # grid (parallel.mesh.make_mesh). Stage 1 runs spatially split (CFG
    # lanes over data, latent H over model, K1b self-attention), stage 2
    # runs the 4+2K lanes split over all ranks, the decode is H-split.
    # None = one device.
    mesh: Optional[mesh_lib.Mesh] = None

    def __post_init__(self):
        if self.cache_schedule not in multiconcept.DEEPCACHE_SCHEDULES:
            raise ValueError(
                f"unknown cache_schedule {self.cache_schedule!r} "
                f"(one of {multiconcept.DEEPCACHE_SCHEDULES})")
        if self.quantize == "int8":
            self.params = self.params._replace(
                unet=quant.quantize_unet(self.params.unet))
        elif self.quantize:
            raise ValueError(f"unknown quantize mode {self.quantize!r}")
        if self.mesh is not None and self.concept_crop:
            raise ValueError(
                "concept_crop and mesh are mutually exclusive (the "
                "strip program is single-chip; the lane-parallel mode "
                "keeps the power-of-two 4+2K layout)")
        if self.cache_interval > 1 and self.concept_crop:
            raise ValueError(
                "cache_interval is exclusive with concept_crop (the "
                "strip program has no shallow variant); it composes "
                "with mesh — the shallow path spatially shards in "
                "stage 1 and the per-lane cache shards with the lanes "
                "in stage 2")

    @property
    def device(self) -> torch.device:
        return self.params.unet.conv_in.weight.device

    def _resolve_cache_spec(self, cache_interval, cache_schedule,
                            steps: int, fusion_start: int):
        """A request's DeepCache spec: 0 (exact), an int interval > 1
        (uniform) or a per-step bool tuple (a schedule, or the caller's
        own list). None takes the engine's defaults; an interval <= 1 is
        0."""
        if isinstance(cache_interval, (tuple, list)):
            spec = tuple(bool(b) for b in cache_interval)
            if len(spec) != steps:
                raise ValueError(
                    f"cache_interval schedule has {len(spec)} entries "
                    f"for {steps} steps")
            return spec
        interval = (self.cache_interval if cache_interval is None
                    else int(cache_interval))
        if interval <= 1:
            return 0
        kind = cache_schedule or self.cache_schedule or "uniform"
        if kind == "uniform":
            return interval
        return multiconcept.deepcache_schedule(
            steps, interval, kind=kind, fusion_start=fusion_start)

    def _check_mesh_weights(self, *models) -> None:
        """Every rank of the mesh holds the same weights on its mesh
        device (each rank built its own copy): the engine's once, and each
        ControlNet or InstantID model the first time a request brings it.
        Every rank passes the same models, so all run the same checks."""
        checked = self.__dict__.setdefault("_mesh_checked", {})
        todo = [m for m in (*self.params, *models)
                if m is not None and checked.get(id(m)) is not m]
        if todo:
            mesh_lib.replicated(self.mesh, *todo)
            checked.update((id(m), m) for m in todo)

    def encode(self, prompt: str, negative: str,
               te_lora: tuple = (None, None)):
        """``te_lora``: (encoder-1, encoder-2) LoRA dicts for region
        prompts."""
        def ids(tok, text):
            return profiling.sync(torch.as_tensor, tok([text]),
                                  dtype=torch.long, device=self.device)

        ep, pp = sdxl.encode_tokens(self.cfg, self.params,
                                    ids(self.tokenizer, prompt),
                                    ids(self.tokenizer_2, prompt), *te_lora)
        en, pn = sdxl.encode_tokens(self.cfg, self.params,
                                    ids(self.tokenizer, negative),
                                    ids(self.tokenizer_2, negative), *te_lora)
        return ep, pp, en, pn

    def _token_in_prompt(self, word: str, prompt: str) -> bool:
        """Detection runs for a class only if the word's token appears in
        the global prompt (the reference's gate)."""
        wid = self.tokenizer.encode_word(word)
        ids = self.tokenizer.encode(prompt)
        return wid in list(ids[1:-1])

    def _predict_masks(self, image, prompt: str, n_regions: int,
                       detection_classes) -> list:
        """Per-concept masks from the stage-1 image, token-gated per class.
        A provider with ``masks_for`` is asked once for all gated classes
        and must answer each one."""
        gated = [(k, detection_classes[k])
                 for k in range(n_regions)
                 if k < len(detection_classes) and detection_classes[k]
                 and self.mask_provider is not None
                 and self._token_in_prompt(detection_classes[k], prompt)]
        masks: list = [None] * n_regions
        if not gated:
            return masks
        mf = getattr(self.mask_provider, "masks_for", None)
        if mf is not None:
            found = list(mf(image, [c for _, c in gated]))
            if len(found) != len(gated):
                raise ValueError(
                    f"mask provider returned {len(found)} masks for "
                    f"{len(gated)} classes {[c for _, c in gated]}")
            for (k, _), m in zip(gated, found):
                masks[k] = m
        else:
            for k, cls in gated:
                masks[k] = self.mask_provider(image, cls)
        return masks

    def _check_cn_geometry(self, controlnet_params, instantid) -> None:
        """Every ControlNet handed in has the engine's ``cn_cfg`` geometry."""
        checks = [(controlnet_params, self.cn_cfg)]
        if instantid is not None:
            checks.append((instantid.identitynet_params,
                           instantid.identitynet_cfg))
        for model, want in checks:
            if model is not None and want is not None and model.cfg != want:
                raise ValueError(f"a ControlNet's geometry {model.cfg} is "
                                 f"not the configured {want}")

    def _region_conditioning(self, prompt_rewrite: str,
                             concept_loras: Sequence[Optional[dict]],
                             style_lora: Optional[dict], tids,
                             instantid: Optional[InstantIDModels] = None,
                             face_embeddings: Sequence = ()) -> tuple:
        """A request's region prompts -> (specs, concept inputs, LoRAs):
        each region prompt encoded with its concept's text-encoder adapters
        (mixed with the style's), the InstantID tokens of its face when
        there is one, and its UNet adapter mixed with the style's and
        scaled by ``concept_lora_scale``."""
        region_specs = rewrite.parse_rewrite(prompt_rewrite)
        concept_inputs, loras_final = [], []
        for k, region in enumerate(region_specs):
            tree_k = concept_loras[k] if k < len(concept_loras) else None
            te_lora = (None, None)
            if tree_k is not None:
                def te_merged(key):
                    char = tree_k.get(key)
                    style = (style_lora.get(key)
                             if isinstance(style_lora, dict) else None)
                    if style is not None and char is not None:
                        return lora_lib.merge_loras(
                            [char, style], list(self.char_style_weights))
                    return char if char is not None else style
                te_lora = (te_merged("text_encoder") or None,
                           te_merged("text_encoder_2") or None)
            rep, rpp, ren, rpn = self.encode(region.prompt,
                                             region.negative_prompt,
                                             te_lora=te_lora)
            ip_ctx = None
            if instantid is not None and k < len(face_embeddings) \
                    and face_embeddings[k] is not None:
                ip_ctx = iid.encode_face_tokens(instantid.resampler_params,
                                                face_embeddings[k])
            concept_inputs.append(multiconcept.make_concept_inputs(
                rep, rpp, ren, rpn, tids, ip_context=ip_ctx))
            unet_tree = tree_k.get("unet", tree_k) if tree_k else None
            style_tree = (style_lora.get("unet", style_lora)
                          if style_lora is not None else None)
            merged = (lora_lib.merge_loras([unet_tree, style_tree],
                                           list(self.char_style_weights))
                      if style_tree is not None else unet_tree)
            loras_final.append(lora_lib.scale_lora(merged,
                                                   self.concept_lora_scale))
        return region_specs, concept_inputs, loras_final

    @profiling.requested("omg.generate", _engine_device)
    def generate(self, prompt: str, *, negative_prompt: str = "",
                 prompt_rewrite: str = "",
                 concept_loras: Sequence[Optional[dict]] = (),
                 style_lora: Optional[dict] = None,
                 seed: int = 14, height: int = 1024, width: int = 1024,
                 guidance_scale: float = 7.5,
                 num_steps: Optional[int] = None,
                 detection_classes: Sequence[str] = ("man", "woman"),
                 spatial_condition: Optional[np.ndarray] = None,
                 controlnet_params=None,
                 controlnet_scale: float = 1.0,
                 control_guidance_start: float = 0.0,
                 control_guidance_end: float = 1.0,
                 controlnet_guess_mode: bool = False,
                 instantid: Optional[InstantIDModels] = None,
                 face_embeddings: Sequence[Optional[np.ndarray]] = (),
                 face_kps_image: Optional[np.ndarray] = None,
                 face_kps_provider=None,
                 masks: Optional[Sequence[Optional[np.ndarray]]] = None,
                 fusion_start: Optional[int] = None,
                 initial_noise: Optional[np.ndarray] = None,
                 scheduler: Optional[str] = None,
                 cache_interval: Optional[int] = None,
                 cache_schedule: Optional[str] = None,
                 ) -> GenerationResult:
        """``controlnet_params``: a ``models.controlnet.ControlNetModel``;
        ``spatial_condition``: its uint8 [H, W, C] condition image.
        ``face_embeddings``: per concept, an ArcFace embedding or None."""
        use_cn = (spatial_condition is not None
                  and controlnet_params is not None)
        self._check_cn_geometry(controlnet_params if use_cn else None,
                                instantid)
        device = self.device
        phases = profiling.Phases(device)
        phases.next("encode")
        steps = num_steps or self.num_steps
        fusion_start = _fusion_start(steps, fusion_start)
        sched = schedulers.make_schedule(scheduler or self.scheduler, steps)
        eff_interval = self._resolve_cache_spec(cache_interval,
                                                cache_schedule, steps,
                                                fusion_start)
        if eff_interval and self.concept_crop:
            raise ValueError(
                "cache_interval is exclusive with concept_crop (the "
                "strip program has no shallow variant); mesh composes")
        # a CPU generator: one seed, one image, on any device
        generator = torch.Generator("cpu").manual_seed(seed)

        # --- conditioning ---------------------------------------------
        ep, pp, en, pn = self.encode(prompt, negative_prompt)
        tids = sdxl.add_time_ids((height, width), (0, 0), (height, width),
                                 device=device)
        base_inputs = multiconcept.make_base_inputs(ep, pp, en, pn, tids,
                                                    guidance_scale)
        region_specs, concept_inputs, loras_final = self._region_conditioning(
            prompt_rewrite, concept_loras, style_lora, tids,
            instantid=instantid, face_embeddings=face_embeddings)
        ip_adapters = ([instantid.ip_adapter_layers] * len(region_specs)
                       if instantid is not None else [])

        base_cns = []
        if use_cn:
            base_cns.append(multiconcept.ControlNetInputs(
                params=controlnet_params,
                cond_image=profiling.sync(
                    torch.as_tensor,
                    np.asarray(spatial_condition, np.float32),
                    device=device)[None] / 255.0,
                scale=float(controlnet_scale),
                guidance_start=float(control_guidance_start),
                guidance_end=float(control_guidance_end),
                guess_mode=bool(controlnet_guess_mode)))

        controller = p2p.P2PControl.build(
            [prompt, prompt], steps, cross_replace_steps=1.0,
            self_replace_steps=0.4, width=width // 32, height=height // 32,
            tokenizer=self.tokenizer, device=device)
        phases.next("stage1")

        # --- stage 1 (dedup fast path) ---------------------------------
        lane_sharding = spatial = None
        if self.mesh is not None:
            self._check_mesh_weights(
                controlnet_params if use_cn else None,
                *((instantid.resampler_params, instantid.identitynet_params,
                   *instantid.ip_adapter_layers)
                  if instantid is not None else ()))
            lane_sharding = self.mesh.flat
            spatial = multiconcept.Spatial(
                self.mesh, seq=seq_splits(self.cfg, height, self.mesh.model))
        lat1, cache = multiconcept.sample_stage1_cached(
            self.cfg, sched, self.params.unet, generator=generator,
            height=height, width=width, base_inputs=base_inputs,
            fusion_start=fusion_start, spatial=spatial,
            # the 4+2K stage 2 of the mesh layout never reads it
            record_trajectory=self.mesh is None,
            initial_noise=initial_noise, base_controlnets=base_cns,
            noise_seed=seed, cache_interval=eff_interval)
        phases.next("decode", timed=True)
        img1 = self._decode(lat1)

        # --- masks -----------------------------------------------------
        phases.next("masks")
        if masks is None:
            masks = self._predict_masks(img1[1], prompt, len(region_specs),
                                        detection_classes)
        masks = list(masks)
        fuse = any(m is not None for m in masks)
        if fuse:
            phases.next("stage2")
        else:
            phases.end()

        # IdentityNet conditions: the keypoints of the faces on the stage-1
        # image, at canvas coordinates; an explicit face_kps_image wins
        concept_cns = []
        if instantid is not None and instantid.identitynet_params is not None:
            if face_kps_image is None and face_kps_provider is not None:
                face_kps_image = face_kps_provider(img1[1])
            if face_kps_image is not None:
                kimg = iid.kps_image_to_cond(face_kps_image, device)
                concept_cns = [multiconcept.ControlNetInputs(
                    params=instantid.identitynet_params, cond_image=kimg,
                    scale=float(instantid.identitynet_scale),
                    encoder_hidden_states=ci.ip_context)
                    for ci in concept_inputs]

        # --- stage 2 ---------------------------------------------------
        # Under a mesh the spatial stage 1 gathered its rows at the end of
        # each range, so the stage cache is whole on every rank: the
        # lane-split stage 2 starts from replicated latents.
        img2 = None
        if fuse:
            mask_stack = regions_lib.make_concept_mask_stack(
                masks, (height // 8, width // 8), len(region_specs),
                device=device)
            lat2 = multiconcept.sample_stage2_resumed(
                self.cfg, sched, self.params.unet, cache,
                base_inputs=base_inputs, controller=controller,
                concept_inputs=concept_inputs, concept_loras=loras_final,
                masks=mask_stack, fusion_start=fusion_start,
                concept_ip_adapters=ip_adapters,
                ip_scale=(instantid.ip_scale if instantid is not None
                          else 1.0),
                base_controlnets=base_cns, concept_controlnets=concept_cns,
                lane_sharding=(lane_sharding if len(region_specs) > 0
                               else None),
                # base-row ControlNets compose with the strips (the base
                # rows run full-frame); per-concept IdentityNet rows and
                # widths that do not split run the exact program
                concept_crop=(self.concept_crop and self.mesh is None
                              and len(region_specs) > 0
                              and not any(c is not None for c in concept_cns)
                              and multiconcept.crop_strips_ok(
                                  self.cfg, width // 8, len(region_specs))),
                cache_interval=(eff_interval if len(region_specs) > 0
                                else 0))
            phases.next("decode", timed=True)
            img2 = self._decode(lat2)
            phases.end()
        return GenerationResult(stage1=img1, stage2=img2, masks=masks,
                                timings=phases.timings)

    def _decode(self, latents: torch.Tensor) -> np.ndarray:
        # under a mesh, H splits over every rank when it divides
        spatial = (self.mesh.flat if self.mesh is not None
                   and latents.shape[1] % self.mesh.size == 0 else None)
        img = sdxl.decode_latents(self.cfg, self.params.vae, latents,
                                  spatial=spatial)
        img = (img * 255).to(torch.uint8)
        return profiling.sync(img.cpu).numpy()

    # --------------------------------------------------- batched serving

    @profiling.requested("omg.generate_batch", _engine_device)
    def generate_batch(self, requests: Sequence[dict]
                       ) -> List[GenerationResult]:
        """R compatible requests as one stage-1 and one stage-2 program:
        each UNet forward runs the lanes of every request (2R in stage 1,
        R(3+2K) in stage 2), and each request keeps its own prompt, seed,
        guidance scale, adapters and scheduler state.

        Request dicts take ``generate``'s keyword arguments. They must
        share height, width, steps, scheduler, fusion start and DeepCache
        spec (the server buckets by these), else ``ValueError``; the batch
        runs exact stage-2 lanes even on a ``concept_crop`` engine. Masks
        are predicted per
        request on the host between the stages; requests padded to the
        largest concept count get neutral concepts with zero masks. Face
        requests batch when they share one ``InstantIDModels`` (no-face
        slots get zero IP tokens and IdentityNet scale 0, exact no-ops);
        spatial-condition requests batch when they share one ControlNet
        (per-request images, scales and windows; the others get scale 0).
        One request, a mesh engine, explicit ``masks``, guess mode,
        ``initial_noise``, or distinct InstantID stacks or ControlNets run
        serially through ``generate``. Every result's ``timings`` holds the
        batch's phase seconds."""
        requests = [self._request_args(r) for r in requests]

        def serial(rs):
            out = []
            for r in rs:
                r = dict(r)
                out.append(self.generate(r.pop("prompt"), **r))
            return out

        unsupported = ("masks", "controlnet_guess_mode", "initial_noise")
        if len(requests) <= 1 or self.mesh is not None or any(
                _given(r[k]) for r in requests for k in unsupported):
            return serial(requests)
        live_iids = [r["instantid"] for r in requests if r["instantid"]]
        live_cnp = [r["controlnet_params"] for r in requests
                    if r["controlnet_params"] is not None]
        if any(x is not live_iids[0] for x in live_iids) or \
                any(c is not live_cnp[0] for c in live_cnp):
            return serial(requests)
        iid_models = live_iids[0] if live_iids else None
        cn_params = live_cnp[0] if live_cnp else None
        self._check_cn_geometry(cn_params, iid_models)

        def bucket(r):
            steps = r["num_steps"] or self.num_steps
            fusion = _fusion_start(steps, r["fusion_start"])
            return (steps, r["height"], r["width"],
                    r["scheduler"] or self.scheduler, fusion,
                    self._resolve_cache_spec(r["cache_interval"],
                                             r["cache_schedule"], steps,
                                             fusion))
        steps, height, width, sched_name, fusion_start, eff_interval = \
            bucket(requests[0])
        if eff_interval and self.concept_crop:
            raise ValueError(
                "cache_interval is exclusive with mesh and concept_crop "
                "(the shallow program is single-chip, full-frame)")
        if any(bucket(r) != bucket(requests[0]) for r in requests[1:]):
            raise ValueError("batched requests must share height/width/"
                             "steps/scheduler/fusion_start/cache_interval "
                             "(bucket them)")
        device = self.device
        phases = profiling.Phases(device)
        phases.next("encode")
        sched = schedulers.make_schedule(sched_name, steps)
        tids = sdxl.add_time_ids((height, width), (0, 0), (height, width),
                                 device=device)

        bases, concepts, loras, specs = [], [], [], []
        for r in requests:
            ep, pp, en, pn = self.encode(r["prompt"], r["negative_prompt"])
            bases.append(multiconcept.make_base_inputs(
                ep, pp, en, pn, tids, r["guidance_scale"]))
            sp, ci, lo = self._region_conditioning(
                r["prompt_rewrite"], r["concept_loras"], r["style_lora"],
                tids, instantid=iid_models if r["instantid"] else None,
                face_embeddings=r["face_embeddings"])
            specs.append(sp)
            concepts.append(ci)
            loras.append(lo)
        # pad every request to one concept count with neutral concepts
        # (their zero masks make the fusion a no-op)
        max_k = max(len(c) for c in concepts)
        if any(len(c) < max_k for c in concepts):
            ep, pp, en, pn = self.encode("", "")
            neutral = multiconcept.make_concept_inputs(ep, pp, en, pn, tids)
            for r_i in range(len(requests)):
                pad = max_k - len(concepts[r_i])
                concepts[r_i] = list(concepts[r_i]) + [neutral] * pad
                loras[r_i] = list(loras[r_i]) + [None] * pad

        def cond_rows(images):
            """uint8 images (None: zeros) -> [R, 1, H, W, C] in [0, 1]."""
            c = next(x for x in images if x is not None).shape[-1]
            return torch.stack([
                profiling.sync(torch.as_tensor, np.asarray(x, np.float32),
                               device=device)[None] / 255.0
                if x is not None else
                torch.zeros((1, height, width, c), device=device)
                for x in images])

        base_cn_conds = None
        has = [r["spatial_condition"] is not None
               and r["controlnet_params"] is not None for r in requests]
        if any(has):
            base_cn_conds = (
                cond_rows([r["spatial_condition"] if h else None
                           for r, h in zip(requests, has)]),
                [float(r["controlnet_scale"]) if h else 0.0
                 for r, h in zip(requests, has)],
                [float(r["control_guidance_start"]) for r in requests],
                [float(r["control_guidance_end"]) for r in requests])
        phases.next("stage1")

        lat1_r, caches = multiconcept.sample_stage1_batch(
            self.cfg, sched, self.params.unet,
            [int(r["seed"]) for r in requests], bases,
            height=height, width=width, fusion_start=fusion_start,
            base_cn_params=cn_params, base_cn_conds_r=base_cn_conds,
            cache_interval=eff_interval)
        phases.next("decode", timed=True)
        img1s = [self._decode(lat) for lat in lat1_r]
        phases.next("masks")
        masks_r = [self._predict_masks(
            img1[1], r["prompt"], len(sp), r["detection_classes"])
            for img1, r, sp in zip(img1s, requests, specs)]
        results = [GenerationResult(stage1=img1, stage2=None, masks=m)
                   for img1, m in zip(img1s, masks_r)]
        live2 = [any(m is not None for m in ms) for ms in masks_r]
        if max_k == 0 or not any(live2):
            phases.end()
            return self._with_timings(results, phases)
        phases.next("stage2")

        # InstantID stage 2: the shared IP layers, and the IdentityNet on
        # the keypoints of each request's own stage-1 faces
        ip_adapters, ip_scale = (), 1.0
        concept_cn_conds = None
        if iid_models is not None:
            ip_adapters, ip_scale = ((iid_models.ip_adapter_layers,),
                                     iid_models.ip_scale)
            if iid_models.identitynet_params is not None:
                kimgs = []
                for r, res in zip(requests, results):
                    kimg = None
                    if r["instantid"]:
                        kimg = r["face_kps_image"]
                        if kimg is None and r["face_kps_provider"]:
                            kimg = r["face_kps_provider"](res.stage1[1])
                    kimgs.append(kimg)
                if any(k is not None for k in kimgs):
                    cond = cond_rows(kimgs)
                    conds_k = []
                    for k in range(max_k):
                        scales, ehs = [], []
                        for r_i, r in enumerate(requests):
                            fe = r["face_embeddings"]
                            live = (r["instantid"]
                                    and kimgs[r_i] is not None
                                    and k < len(fe) and fe[k] is not None)
                            scales.append(iid_models.identitynet_scale
                                          if live else 0.0)
                            ehs.append(concepts[r_i][k].ip_context)
                        tmpl = next((e for e in ehs if e is not None), None)
                        conds_k.append((cond, scales, None if tmpl is None
                                        else torch.stack([
                                            e if e is not None else
                                            torch.zeros_like(tmpl)
                                            for e in ehs])))
                    concept_cn_conds = tuple(conds_k)

        mask_stacks = torch.stack([
            regions_lib.make_concept_mask_stack(
                m, (height // 8, width // 8), max_k, device=device)
            for m in masks_r])
        controller = p2p.P2PControl.build(
            [requests[0]["prompt"]] * 2, steps, cross_replace_steps=1.0,
            self_replace_steps=0.4, width=width // 32, height=height // 32,
            tokenizer=self.tokenizer, device=device)
        lat2_r = multiconcept.sample_stage2_batch(
            self.cfg, sched, self.params.unet, caches, bases, controller,
            concepts, loras, mask_stacks, fusion_start=fusion_start,
            ip_scale=ip_scale, concept_ip_adapters=ip_adapters,
            concept_cn_params=(iid_models.identitynet_params
                               if concept_cn_conds is not None else None),
            concept_cn_conds_r=concept_cn_conds,
            base_cn_params=cn_params, base_cn_conds_r=base_cn_conds,
            cache_interval=eff_interval)
        phases.next("decode", timed=True)
        results = [dataclasses.replace(res, stage2=self._decode(lat))
                   if live else res
                   for res, lat, live in zip(results, lat2_r, live2)]
        phases.end()
        return self._with_timings(results, phases)

    def _request_args(self, request: dict) -> dict:
        """A request dict with every ``generate`` default filled in, so
        that a batched request reads the values its serial run would."""
        rest = dict(request)
        args = inspect.signature(self.generate).bind(rest.pop("prompt"),
                                                     **rest)
        args.apply_defaults()
        return dict(args.arguments)

    @staticmethod
    def _with_timings(results: list, phases: profiling.Phases) -> list:
        return [dataclasses.replace(r, timings=dict(phases.timings))
                for r in results]
