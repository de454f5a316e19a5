"""SAM predictor and the mask provider the OMG pipeline calls (port of
``omg_tpu/segment/sam_provider.py``).

The reference predictor's flow (efficientvit sam.py:244-459): resize the
long side to the encoder's input size, normalize, pad; cache the image
embedding on the device; prompt with a box; decode multimask; pick the
best by IoU; upscale and crop back to the original size; threshold at 0.

Detection is pluggable (``box_provider(image, text) -> xyxy | None``);
without one the provider prompts with the whole image.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from omg_tpu_torch import convert
from omg_tpu_torch.nn import layers
from omg_tpu_torch.segment import efficientvit as evit
from omg_tpu_torch.segment import evit_ops as ops
from omg_tpu_torch.segment import sam_decoder as dec
from omg_tpu_torch.segment import vit_sam

EncoderConfig = Union[evit.EViTSamConfig, vit_sam.VitSamConfig]

_MEAN = (123.675, 116.28, 103.53)
_STD = (58.395, 57.12, 57.375)


class Sam(nn.Module):
    """segment_anything's ``Sam`` container: ``image_encoder`` (either
    family), ``prompt_encoder``, ``mask_decoder``."""

    def __init__(self, image_encoder: nn.Module,
                 prompt_encoder: dec.PromptEncoder,
                 mask_decoder: dec.MaskDecoder):
        super().__init__()
        self.image_encoder = image_encoder
        self.prompt_encoder = prompt_encoder
        self.mask_decoder = mask_decoder


def encoder_config(state: Mapping) -> EncoderConfig:
    """The encoder family and geometry of an image-encoder state dict: the
    SAM ViT (its ``patch_embed.*`` keys; B/L/H read off the shapes), else
    the EfficientViT zoo geometry its stages match, else XL1."""
    if any(k.startswith("patch_embed.") for k in state):
        return vit_sam.config_from_params(state)
    return evit.infer_config(state) or evit.xl1_config()


def make_encoder(cfg: EncoderConfig, device=None) -> nn.Module:
    if isinstance(cfg, vit_sam.VitSamConfig):
        return vit_sam.ImageEncoderViT(cfg, device)
    return evit.EfficientViTSamImageEncoder(cfg, device)


# Upstream keys with no module here: BatchNorm counters, the mask-prompt
# downscaler (the port prompts with boxes and points only) and
# segment_anything's pixel normalization buffers.
SAM_SKIP = (r"num_batches_tracked$", r"^prompt_encoder\.mask_downscaling\.",
            r"^pixel_(mean|std)$")


def convert_sam_checkpoint(path_or_sd, *,
                           cfg: Optional[EncoderConfig] = None,
                           device="cuda") -> Sam:
    """A SAM checkpoint, EfficientViT-SAM (``xl1.pt``) or SAM ViT-B/L/H
    (``sam_vit_h_4b8939.pth``), file or state dict -> the port's ``Sam``
    on ``device``. The encoder's family and geometry are ``cfg``, or else
    read off its keys (``encoder_config``). The upstream layouts load as
    they are: the decoder's ConvTranspose kernels are torch's
    [in, out, k, k] and the prompt/mask tokens [n, 256] tables."""
    device = layers.target_device(device, "convert_sam_checkpoint")
    sd = convert.filter_keys(convert.as_state_dict(path_or_sd), SAM_SKIP)
    if cfg is None:
        pre = "image_encoder."
        cfg = encoder_config({k[len(pre):]: v for k, v in sd.items()
                              if k.startswith(pre)})
    sam = Sam(make_encoder(cfg, device), dec.PromptEncoder(device),
              dec.MaskDecoder(device))
    return convert.copy_into(sam, sd)


def init_sam(generator: torch.Generator, cfg: EncoderConfig,
             device=None) -> Sam:
    """A SAM with random weights from ``generator`` on ``device`` (the
    generator's device when None): the encoder of ``cfg``'s family, then
    the prompt encoder and the mask decoder."""
    mod = vit_sam if isinstance(cfg, vit_sam.VitSamConfig) else evit
    return Sam(mod.init_params(generator, cfg, device),
               dec.init_prompt_encoder(generator, device),
               dec.init_mask_decoder(generator, device))


class SamPredictor:
    """``set_image`` once, ``predict_box`` many times; the embedding stays
    on the device (reference: sam.py:276-295)."""

    def __init__(self, sam: Sam):
        self.sam = sam
        self.cfg = sam.image_encoder.cfg
        self._embedding = None
        self._orig_size = None
        self._input_size = None

    @property
    def device(self) -> torch.device:
        return self.sam.prompt_encoder.no_mask_embed.weight.device

    def _preprocess(self, image: np.ndarray) -> torch.Tensor:
        """uint8 [H, W, 3] -> [1, S, S, 3]: the long side resized to S
        (bilinear as PIL does it, on uint8 levels), normalized, zero
        padded at the bottom and right."""
        s = self.cfg.image_size
        h, w = image.shape[:2]
        scale = s / max(h, w)
        nh, nw = round(h * scale), round(w * scale)
        x = ops.resize_uint8(image, (nh, nw), self.device)
        x = (x - torch.tensor(_MEAN, device=x.device)) \
            / torch.tensor(_STD, device=x.device)
        out = x.new_zeros(1, s, s, 3)
        out[0, :nh, :nw] = x
        self._input_size = (nh, nw)
        return out

    def set_image(self, image: np.ndarray) -> None:
        self._orig_size = image.shape[:2]
        x = self._preprocess(image).to(self.cfg.dtype)
        self._embedding = self.sam.image_encoder(x)

    def predict_box(self, box_xyxy: np.ndarray) -> tuple:
        """-> (mask [H, W] bool at the original size, IoU score)."""
        if self._embedding is None:
            raise RuntimeError("call set_image first")
        h, w = self._orig_size
        nh, nw = self._input_size
        s = self.cfg.image_size
        box = torch.as_tensor(np.asarray(box_xyxy, np.float32),
                              device=self.device) * (s / max(h, w))
        pe = self.sam.prompt_encoder
        sparse = dec.encode_boxes(pe, box[None], float(s))
        dense = dec.no_mask_dense(pe, 1, self._embedding.shape[1])
        masks, iou = dec.decode_masks(self.sam.mask_decoder, pe,
                                      self._embedding, sparse, dense)
        # multimask selection: rows 1:4, best IoU (predictor behavior)
        best = int(torch.argmax(iou[0, 1:])) + 1
        m = ops.bilinear_resize(masks[:, best:best + 1], (s, s))
        m = ops.bilinear_resize(m[:, :, :nh, :nw], (h, w))[0, 0]
        return (m > 0.0).cpu().numpy(), float(iou[0, best])


def full_image_box(image: np.ndarray, text: str):
    h, w = image.shape[:2]
    return np.array([0.0, 0.0, w, h], np.float32)


class SamMaskProvider:
    """MaskProvider: detector box -> SAM mask (the reference's
    predict_mask, inference_lora.py:91-126). The model is ``sam``, or else
    the ``checkpoint`` file's (``convert_sam_checkpoint``, the encoder's
    geometry ``cfg`` or read off the file), on ``device``, the card unless
    the caller asks for the CPU."""

    def __init__(self, checkpoint: str = "",
                 box_provider: Optional[Callable] = None,
                 sam: Optional[Sam] = None,
                 cfg: Optional[EncoderConfig] = None, *, device="cuda"):
        device = layers.target_device(device, "SamMaskProvider")
        if sam is None:
            sam = convert_sam_checkpoint(checkpoint, cfg=cfg, device=device)
        self.predictor = SamPredictor(sam.to(device))
        self.box_provider = box_provider or full_image_box
        self._cached_image_id = None

    def __call__(self, image: np.ndarray, text: str):
        from omg_tpu_torch.segment import image_fingerprint
        box = self.box_provider(image, text)
        if box is None:
            return None
        img_id = image_fingerprint(image)
        if img_id != self._cached_image_id:
            self.predictor.set_image(image)
            self._cached_image_id = img_id
        mask, _score = self.predictor.predict_box(box)
        return mask.astype(np.float32)

    def masks_for(self, image: np.ndarray, texts) -> list:
        """All classes at once: a box_provider that assigns classes
        jointly (``OpenVocabDetector.assign_jointly``, the global best over
        (class, proposal) pairs) does so first, so no class's answer
        depends on the order of the queries; then one call per class."""
        joint = getattr(self.box_provider, "assign_jointly", None)
        if joint is not None:
            joint(image, list(texts))
        return [self(image, t) for t in texts]
