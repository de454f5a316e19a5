"""OpenPose body-pose estimation, the "Human pose" condition preprocessor
(port of ``omg_tpu/models/openpose.py``).

The CMU two-branch body model: a VGG trunk and six stages predicting Part
Affinity Fields (38 channels) and keypoint heatmaps (19) at stride 8.
``BodyModel`` holds the same ``_TRUNK``/``_stage1``/``_stageN`` tables as
the JAX package, with the checkpoint's layer names, NCHW convs and 2x2
max pools. The multi-person decode (peak finding, PAF line-integral
scoring, greedy limb assembly) is the JAX package's host code (numpy and
scipy), and ``draw_bodypose`` renders through ``utils/cv`` (cv2's
rasterizers without cv2).

``BodyEstimator`` follows the JAX provider's procedure: one 0.5x scale
around boxsize 368, cv2's cubic resize of the photo (``utils/cv``; the
JAX package gets IPP's when its cv2 has the IPP HAL, which differs by one
level on a few per cent of pixels), stride-8 padding with 128, the
network in fp32 on its device, the stage-6 maps upsampled 8x, cropped
and resized to the photo (torch bicubic on the device, cv2's kernel),
then the decode and the drawing on the host. The convolutions take TF32
off per call (``layers.conv_fp32``; cuDNN's default would take it on):
the decode compares the maps with 0.1 and 0.05.

``convert_state_dict`` takes ``body_pose_model.pth`` keys, raw
(``conv1_1.weight``) or with controlnet_aux's segment prefix
(``model0.conv1_1.weight``, ``model1_1.conv5_1_CPM_L1.weight``, ...).
"""

from __future__ import annotations

import math
from typing import List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from omg_tpu_torch.nn import layers
from omg_tpu_torch.utils import cv

# (name, in_ch, out_ch, kernel) per sequential segment. ReLU after every
# conv except each branch's last (conv5_5_*/Mconv7_*). 'pool' = 2x2/2 max.
_TRUNK = [
    ("conv1_1", 3, 64, 3), ("conv1_2", 64, 64, 3), "pool",
    ("conv2_1", 64, 128, 3), ("conv2_2", 128, 128, 3), "pool",
    ("conv3_1", 128, 256, 3), ("conv3_2", 256, 256, 3),
    ("conv3_3", 256, 256, 3), ("conv3_4", 256, 256, 3), "pool",
    ("conv4_1", 256, 512, 3), ("conv4_2", 512, 512, 3),
    ("conv4_3_CPM", 512, 256, 3), ("conv4_4_CPM", 256, 128, 3),
]

PAF_CH = 38     # 19 limbs x (x, y)
HEAT_CH = 19    # 18 body parts + background


def _stage1(branch: str, out_ch: int) -> list:
    return [(f"conv5_{i}_CPM_{branch}", 128, 128, 3) for i in (1, 2, 3)] + [
        (f"conv5_4_CPM_{branch}", 128, 512, 1),
        (f"conv5_5_CPM_{branch}", 512, out_ch, 1),
    ]


def _stageN(n: int, branch: str, out_ch: int) -> list:
    in_ch = 128 + PAF_CH + HEAT_CH
    seq = [(f"Mconv1_stage{n}_{branch}", in_ch, 128, 7)]
    seq += [(f"Mconv{i}_stage{n}_{branch}", 128, 128, 7) for i in (2, 3, 4, 5)]
    seq += [(f"Mconv6_stage{n}_{branch}", 128, 128, 1),
            (f"Mconv7_stage{n}_{branch}", 128, out_ch, 1)]
    return seq


def _all_convs() -> list:
    convs = [c for c in _TRUNK if c != "pool"]
    convs += _stage1("L1", PAF_CH) + _stage1("L2", HEAT_CH)
    for n in range(2, 7):
        convs += _stageN(n, "L1", PAF_CH) + _stageN(n, "L2", HEAT_CH)
    return convs


class BodyModel(nn.Module):
    """The body network; one ``layers.Conv2d`` per checkpoint layer, named
    as in ``body_pose_model.pth``. ``width_mult`` shrinks the channels as
    the JAX ``init_params`` does (kernel geometry and graph exact)."""

    def __init__(self, width_mult: float = 1.0, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.width_mult = width_mult

        def scale(c):
            return max(int(c * width_mult), 4) \
                if c not in (3, PAF_CH, HEAT_CH) else c

        for name, cin, cout, k in _all_convs():
            cin_s = scale(cin) if cin != 128 + PAF_CH + HEAT_CH else (
                scale(128) + PAF_CH + HEAT_CH)
            self.add_module(name, layers.Conv2d(cin_s, scale(cout), k,
                                                dtype=dtype, device=device))

    def _run_seq(self, x: torch.Tensor, seq: list, *,
                 final_relu: bool) -> torch.Tensor:
        last = [c for c in seq if c != "pool"][-1][0]
        for item in seq:
            if item == "pool":
                x = F.max_pool2d(x, 2, 2)
                continue
            name = item[0]
            conv = getattr(self, name)
            x = layers.conv_fp32(x, conv.weight, conv.bias,
                                 padding=conv.padding)
            if final_relu or name != last:
                x = F.relu(x)
        return x

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: [B, 3, H, W] normalized (im/256 - 0.5) -> (paf [B, 38, H/8,
        W/8], heatmap [B, 19, H/8, W/8])."""
        feat = self._run_seq(x, _TRUNK, final_relu=True)
        paf = self._run_seq(feat, _stage1("L1", PAF_CH), final_relu=False)
        heat = self._run_seq(feat, _stage1("L2", HEAT_CH), final_relu=False)
        for n in range(2, 7):
            h = torch.cat([paf, heat, feat], dim=1)
            paf = self._run_seq(h, _stageN(n, "L1", PAF_CH), final_relu=False)
            heat = self._run_seq(h, _stageN(n, "L2", HEAT_CH),
                                 final_relu=False)
        return paf, heat


def init_params(generator: torch.Generator, width_mult: float = 1.0,
                device=None) -> BodyModel:
    """A body model with random weights from ``generator`` on ``device``
    (the generator's device when None)."""
    return layers.init_params(
        BodyModel(width_mult, device or generator.device), generator)


# --------------------------------------------------------------------------
# Host-side multi-person decode (numpy/scipy; reference semantics:
# controlnet_aux.open_pose.body.Body.__call__)
# --------------------------------------------------------------------------

# 1-based limb endpoints and their PAF channel pairs (CMU convention).
LIMB_SEQ = [[2, 3], [2, 6], [3, 4], [4, 5], [6, 7], [7, 8], [2, 9], [9, 10],
            [10, 11], [2, 12], [12, 13], [13, 14], [2, 1], [1, 15], [15, 17],
            [1, 16], [16, 18], [3, 17], [6, 18]]
MAP_IDX = [[31, 32], [39, 40], [33, 34], [35, 36], [41, 42], [43, 44],
           [19, 20], [21, 22], [23, 24], [25, 26], [27, 28], [29, 30],
           [47, 48], [49, 50], [53, 54], [51, 52], [55, 56], [37, 38],
           [45, 46]]

# Skeleton colors ControlNet-openpose was trained against.
COLORS = [[255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0],
          [170, 255, 0], [85, 255, 0], [0, 255, 0], [0, 255, 85],
          [0, 255, 170], [0, 255, 255], [0, 170, 255], [0, 85, 255],
          [0, 0, 255], [85, 0, 255], [170, 0, 255], [255, 0, 255],
          [255, 0, 170], [255, 0, 85]]


def find_peaks(heatmap: np.ndarray, thre1: float = 0.1) -> List[list]:
    """Per-part peak lists [(x, y, score, global_id), ...] from a
    [H, W, 19] heatmap (channel 18 is background)."""
    from scipy.ndimage import gaussian_filter
    all_peaks = []
    peak_counter = 0
    for part in range(HEAT_CH - 1):
        map_ori = heatmap[:, :, part]
        one_heatmap = gaussian_filter(map_ori, sigma=3)
        map_left = np.zeros_like(one_heatmap)
        map_left[1:, :] = one_heatmap[:-1, :]
        map_right = np.zeros_like(one_heatmap)
        map_right[:-1, :] = one_heatmap[1:, :]
        map_up = np.zeros_like(one_heatmap)
        map_up[:, 1:] = one_heatmap[:, :-1]
        map_down = np.zeros_like(one_heatmap)
        map_down[:, :-1] = one_heatmap[:, 1:]
        peaks_binary = np.logical_and.reduce(
            (one_heatmap >= map_left, one_heatmap >= map_right,
             one_heatmap >= map_up, one_heatmap >= map_down,
             one_heatmap > thre1))
        peaks = list(zip(np.nonzero(peaks_binary)[1],
                         np.nonzero(peaks_binary)[0]))      # (x, y)
        peaks_with_score = [x + (map_ori[x[1], x[0]],) for x in peaks]
        peak_id = range(peak_counter, peak_counter + len(peaks))
        all_peaks.append([peaks_with_score[i] + (peak_id[i],)
                          for i in range(len(peak_id))])
        peak_counter += len(peaks)
    return all_peaks


def score_limbs(paf: np.ndarray, all_peaks: List[list], ori_h: int,
                thre2: float = 0.05) -> Tuple[list, list]:
    """PAF line-integral limb scoring -> (connection_all, special_k)."""
    mid_num = 10
    connection_all, special_k = [], []
    for k in range(len(MAP_IDX)):
        score_mid = paf[:, :, [i - 19 for i in MAP_IDX[k]]]
        candA = all_peaks[LIMB_SEQ[k][0] - 1]
        candB = all_peaks[LIMB_SEQ[k][1] - 1]
        if len(candA) == 0 or len(candB) == 0:
            special_k.append(k)
            connection_all.append([])
            continue
        connection_candidate = []
        for i, a in enumerate(candA):
            for j, b in enumerate(candB):
                vec = np.subtract(b[:2], a[:2])
                norm = max(math.hypot(vec[0], vec[1]), 1e-8)
                vec = np.divide(vec, norm)
                xs = np.linspace(a[0], b[0], num=mid_num)
                ys = np.linspace(a[1], b[1], num=mid_num)
                vec_x = np.array([
                    score_mid[int(round(ys[t])), int(round(xs[t])), 0]
                    for t in range(mid_num)])
                vec_y = np.array([
                    score_mid[int(round(ys[t])), int(round(xs[t])), 1]
                    for t in range(mid_num)])
                score_midpts = vec_x * vec[0] + vec_y * vec[1]
                score_with_dist_prior = (
                    score_midpts.mean()
                    + min(0.5 * ori_h / norm - 1, 0))
                crit1 = np.count_nonzero(
                    score_midpts > thre2) > 0.8 * len(score_midpts)
                crit2 = score_with_dist_prior > 0
                if crit1 and crit2:
                    connection_candidate.append(
                        [i, j, score_with_dist_prior,
                         score_with_dist_prior + a[2] + b[2]])
        connection_candidate.sort(key=lambda x: x[2], reverse=True)
        connection = np.zeros((0, 5))
        for i, j, s, _ in connection_candidate:
            if i not in connection[:, 3] and j not in connection[:, 4]:
                connection = np.vstack(
                    [connection, [candA[i][3], candB[j][3], s, i, j]])
                if len(connection) >= min(len(candA), len(candB)):
                    break
        connection_all.append(connection)
    return connection_all, special_k


def assemble_people(all_peaks: List[list], connection_all: list,
                    special_k: list) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy limb-to-person assembly -> (candidate [N,4], subset [P,20]).

    subset row: indices into candidate for the 18 parts, then total
    score, then part count.
    """
    subset = -1 * np.ones((0, 20))
    candidate = np.array(
        [item for sublist in all_peaks for item in sublist])
    if candidate.size == 0:
        return candidate.reshape(0, 4), subset
    for k in range(len(MAP_IDX)):
        if k in special_k:
            continue
        partAs = connection_all[k][:, 0]
        partBs = connection_all[k][:, 1]
        indexA, indexB = np.array(LIMB_SEQ[k]) - 1
        for i in range(len(connection_all[k])):
            found = 0
            subset_idx = [-1, -1]
            for j in range(len(subset)):
                if (subset[j][indexA] == partAs[i]
                        or subset[j][indexB] == partBs[i]):
                    subset_idx[found] = j
                    found += 1
            if found == 1:
                j = subset_idx[0]
                if subset[j][indexB] != partBs[i]:
                    subset[j][indexB] = partBs[i]
                    subset[j][-1] += 1
                    subset[j][-2] += (candidate[partBs[i].astype(int), 2]
                                      + connection_all[k][i][2])
            elif found == 2:
                j1, j2 = subset_idx
                membership = ((subset[j1] >= 0).astype(int)
                              + (subset[j2] >= 0).astype(int))[:-2]
                if len(np.nonzero(membership == 2)[0]) == 0:
                    subset[j1][:-2] += subset[j2][:-2] + 1
                    subset[j1][-2:] += subset[j2][-2:]
                    subset[j1][-2] += connection_all[k][i][2]
                    subset = np.delete(subset, j2, 0)
                else:
                    subset[j1][indexB] = partBs[i]
                    subset[j1][-1] += 1
                    subset[j1][-2] += (candidate[partBs[i].astype(int), 2]
                                       + connection_all[k][i][2])
            elif not found and k < 17:
                row = -1 * np.ones(20)
                row[indexA] = partAs[i]
                row[indexB] = partBs[i]
                row[-1] = 2
                row[-2] = (sum(candidate[
                    connection_all[k][i, :2].astype(int), 2])
                    + connection_all[k][i][2])
                subset = np.vstack([subset, row])
    delete_idx = [i for i in range(len(subset))
                  if subset[i][-1] < 4 or subset[i][-2] / subset[i][-1] < 0.4]
    subset = np.delete(subset, delete_idx, axis=0)
    return candidate, subset


def draw_bodypose(canvas: np.ndarray, candidate: np.ndarray,
                  subset: np.ndarray) -> np.ndarray:
    """Render the skeleton in the ControlNet-openpose training convention
    (stick ellipses at 0.6 alpha + keypoint dots)."""
    stickwidth = 4
    for k in range(17):
        for n in range(len(subset)):
            index = subset[n][np.array(LIMB_SEQ[k]) - 1]
            if -1 in index:
                continue
            cur_canvas = canvas.copy()
            Y = candidate[index.astype(int), 0]
            X = candidate[index.astype(int), 1]
            mX, mY = X.mean(), Y.mean()
            length = math.hypot(X[0] - X[1], Y[0] - Y[1])
            angle = math.degrees(math.atan2(X[0] - X[1], Y[0] - Y[1]))
            polygon = cv.ellipse2poly(
                (int(mY), int(mX)), (int(length / 2), stickwidth),
                int(angle), 0, 360, 1)
            cv.fill_convex_poly(cur_canvas, polygon, COLORS[k])
            canvas = cv.add_weighted(canvas, 0.4, cur_canvas, 0.6, 0)
    for i in range(18):
        for n in range(len(subset)):
            index = int(subset[n][i])
            if index == -1:
                continue
            x, y = candidate[index][0:2]
            cv.circle(canvas, (int(x), int(y)), 4, COLORS[i])
    return canvas


class BodyEstimator:
    """End-to-end pose-condition provider (photo -> skeleton map).

    Mirrors controlnet_aux's Body.__call__ procedure: single 0.5x
    scale-search around boxsize 368, stride-8 padding, cubic upsampling
    of the stage-6 maps back to image resolution, then decode + render.
    ``model``'s device is where the network and the upsampling run.
    """

    def __init__(self, model: BodyModel, *, boxsize: int = 368,
                 stride: int = 8, pad_value: int = 128,
                 scale_search: Tuple[float, ...] = (0.5,)):
        self.model = model.float().eval()
        self.device = next(model.parameters()).device
        self.boxsize = boxsize
        self.stride = stride
        self.pad_value = pad_value
        self.scale_search = scale_search

    def network_input(self, image: np.ndarray, scale: float) -> tuple:
        """The network's input at one scale: (fp32 CPU tensor [1, 3, H', W'],
        normalized, padded to the stride with 128; (h, w), the resized
        photo's size inside it)."""
        mult = scale * self.boxsize / image.shape[0]
        scaled = cv.resize_cubic(image, fx=mult, fy=mult)
        h, w = scaled.shape[:2]
        pad_h = (self.stride - h % self.stride) % self.stride
        pad_w = (self.stride - w % self.stride) % self.stride
        padded = np.pad(scaled, ((0, pad_h), (0, pad_w), (0, 0)),
                        constant_values=self.pad_value)
        x = padded.astype(np.float32) / 256.0 - 0.5
        return torch.from_numpy(x.transpose(2, 0, 1)[None].copy()), (h, w)

    @torch.no_grad()
    def maps(self, image: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """image: [H, W, 3] uint8 -> (heat [H, W, 19], paf [H, W, 38])
        float32, averaged over the scales."""
        ori_h, ori_w = image.shape[:2]
        heat_avg = np.zeros((ori_h, ori_w, HEAT_CH), np.float32)
        paf_avg = np.zeros((ori_h, ori_w, PAF_CH), np.float32)
        for scale in self.scale_search:
            x, (h, w) = self.network_input(image, scale)
            paf, heat = self.model(x.to(self.device))

            def up(m):
                m = cv.resize_cubic(m, fx=self.stride, fy=self.stride)
                m = cv.resize_cubic(m[:, :, :h, :w], (ori_w, ori_h))
                return m[0].permute(1, 2, 0).cpu().numpy()

            heat_avg += up(heat) / len(self.scale_search)
            paf_avg += up(paf) / len(self.scale_search)
        return heat_avg, paf_avg

    def decode(self, heat: np.ndarray, paf: np.ndarray,
               ori_h: int) -> Tuple[np.ndarray, np.ndarray]:
        """Maps -> (candidate, subset), on the host."""
        all_peaks = find_peaks(heat)
        connection_all, special_k = score_limbs(paf, all_peaks, ori_h)
        return assemble_people(all_peaks, connection_all, special_k)

    def estimate(self, image: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """image: [H, W, 3] uint8 (BGR or RGB — PAF decode is colorspace
        agnostic given matching weights). Returns (candidate, subset)."""
        heat, paf = self.maps(image)
        return self.decode(heat, paf, image.shape[0])

    def __call__(self, image: np.ndarray) -> np.ndarray:
        """Photo -> pose-condition image (black canvas + skeleton),
        same size as the input."""
        candidate, subset = self.estimate(image)
        canvas = np.zeros_like(image)
        return draw_bodypose(canvas, candidate, subset)


def convert_state_dict(sd: Mapping[str, torch.Tensor]) -> dict:
    """``body_pose_model.pth`` keys -> ``BodyModel`` keys: the segment
    prefix (``model0.``, ``model1_1.``, ...) dropped; layouts as they
    are (OIHW)."""
    out = {}
    for key, val in sd.items():
        parts = key.split(".")
        if parts[0].startswith("model"):
            parts = parts[1:]
        out[".".join(parts)] = torch.as_tensor(val)
    return out


def load_body_model(path: str, device="cuda") -> BodyEstimator:
    """``body_pose_model.pth`` (a torch state dict) -> the provider, the
    network on ``device`` (the card unless the caller asks for the CPU).
    The width comes from the file (``conv1_1``'s 64 channels at full
    width)."""
    from omg_tpu_torch import convert
    device = layers.target_device(device, "load_body_model")
    sd = convert_state_dict(torch.load(path, map_location="cpu",
                                       weights_only=True))
    width_mult = sd["conv1_1.weight"].shape[0] / 64
    return BodyEstimator(convert.copy_into(
        BodyModel(width_mult, device=device), sd))
