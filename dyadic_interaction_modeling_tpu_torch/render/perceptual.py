"""Perceptual losses (reference ``Pirender/loss/perceptual.py``), on NCHW
tensors.

Counterpart of ``dyadic_interaction_modeling_tpu/render/perceptual.py``:

* the feature trunks the reference offers (perceptual.py:203-343): VGG19,
  VGG16, AlexNet, ResNet-50 (and the robust ResNet-50's checkpoint layout),
  Inception-v3 and VGG-Face, as ``nn.Module``s under torchvision's attribute
  names (VGG-Face under ``vgg_face_dag``'s), so a saved torchvision
  state_dict loads with ``strict=True`` once the classifier head the trunk
  never runs is dropped (``load_trunk_state_dict``). Each returns its taps
  as a dict; BatchNorm runs in eval mode and the trunks stay frozen;
* ``PerceptualLoss``: images in [-1, 1] imagenet-normalised, feature
  distances (l1 or l2, optionally instance-normalised and masked) averaged
  over ``num_scales`` dyadic downscales, and the gram-matrix style loss at
  scale 0 weighted ``weight_style_to_perceptual`` (250 for the final loss,
  config/face.yaml:40-44); ``network="l1"`` is plain L1.

No weights are in the repository: without a state_dict each trunk runs at
torch's random init, still a valid training signal (random-feature
perceptual distance), as the JAX package allows.

Resizing follows ``jax.image.resize(..., "bilinear")``, which antialiases
when it shrinks: every shrinking resize (the scale halvings, ``resize`` from
larger than 224, a mask shrunk to a feature map) is ``F.interpolate`` with
``antialias=True``, and every growing one plain bilinear; both with half-pixel
centres (``align_corners=False``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

_VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]
_VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"]


def _vgg_tap_names(cfg) -> Dict[str, int]:
    """'relu_b_i' -> conv index, in the configuration's order."""
    taps = {}
    block, idx_in_block, conv_idx = 1, 1, 0
    for v in cfg:
        if v == "M":
            block += 1
            idx_in_block = 1
        else:
            taps[f"relu_{block}_{idx_in_block}"] = conv_idx
            conv_idx += 1
            idx_in_block += 1
    return taps


VGG19_TAPS = _vgg_tap_names(_VGG19_CFG)
VGG16_TAPS = _vgg_tap_names(_VGG16_CFG)
# reference taps (perceptual.py:239-252): conv_i before the relu, relu_i after
ALEXNET_TAPS = {f"{kind}_{i + 1}": i for i in range(5) for kind in ("conv", "relu")}
RESNET50_TAPS = ("layer_1", "layer_2", "layer_3", "layer_4")
INCEPTION_TAPS = ("pool_1", "pool_2", "mixed_6e", "pool_3")
VGGFACE_TAPS = ("avgpool", "fc6", "relu_6", "fc7", "relu_7", "fc8")


class _Frozen(nn.Module):
    """A feature trunk: no parameter trains and BatchNorm stays in eval mode
    whatever ``train()`` is asked (the reference runs them requires_grad=False
    in eval). A trunk builds only what its deepest tap needs, as the JAX
    trunks hold params only that far; ``skipped`` lists the state_dict
    prefixes of the parts it left out."""

    skipped: tuple = ()

    def freeze(self):
        for p in self.parameters():
            p.requires_grad_(False)
        return self.train(False)

    def train(self, mode: bool = True):
        return super().train(False)


def _vgg_features(cfg) -> nn.Sequential:
    """torchvision's ``vgg*.features``: conv, relu pairs and max pools."""
    mods, cin = [], 3
    for v in cfg:
        if v == "M":
            mods.append(nn.MaxPool2d(2, 2))
        else:
            mods += [nn.Conv2d(cin, v, 3, padding=1), nn.ReLU()]
            cin = v
    return nn.Sequential(*mods)


class _VGGFeatures(_Frozen):
    cfg: list = []
    taps: Dict[str, int] = {}

    def __init__(self, layers: Sequence[str]):
        super().__init__()
        self.layers = list(layers)
        full = _vgg_features(self.cfg)
        relus = [i for i, m in enumerate(full) if isinstance(m, nn.ReLU)]
        depth = relus[max(self.taps[name] for name in self.layers)] + 1
        self.features = full[:depth]
        self.skipped = tuple(f"features.{i}." for i in range(depth, len(full)))
        self.freeze()

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        wanted = {self.taps[name]: name for name in self.layers}
        feats, conv_idx = {}, 0
        for mod in self.features:
            x = mod(x)
            if isinstance(mod, nn.ReLU):
                if conv_idx in wanted:
                    feats[wanted[conv_idx]] = x
                conv_idx += 1
        return feats


class VGG19Features(_VGGFeatures):
    """VGG19 trunk with taps at the ``relu_b_i`` activations
    (JAX ``render/perceptual.py:59``)."""

    cfg, taps = _VGG19_CFG, VGG19_TAPS


class VGG16Features(_VGGFeatures):
    """VGG16 trunk, relu taps (reference _vgg16, perceptual.py:222-237)."""

    cfg, taps = _VGG16_CFG, VGG16_TAPS


class AlexNetFeatures(_Frozen):
    """AlexNet trunk with the reference's conv / relu taps (_alexnet,
    perceptual.py:239-252); ``features.{0,3,6,8,10}`` are its convs."""

    def __init__(self, layers: Sequence[str]):
        super().__init__()
        self.layers = list(layers)
        self.features = nn.Sequential(
            nn.Conv2d(3, 64, 11, 4, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, padding=2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2d(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, padding=1), nn.ReLU(), nn.MaxPool2d(3, 2))
        self.freeze()

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats, conv_idx = {}, 0
        for mod in self.features:
            x = mod(x)
            if isinstance(mod, nn.Conv2d):
                conv_idx += 1
                if f"conv_{conv_idx}" in self.layers:
                    feats[f"conv_{conv_idx}"] = x
            elif isinstance(mod, nn.ReLU) and f"relu_{conv_idx}" in self.layers:
                feats[f"relu_{conv_idx}"] = x
        return feats


class Bottleneck(nn.Module):
    """torchvision's ResNet bottleneck (stride on the 3x3 conv)."""

    def __init__(self, cin: int, width: int, stride: int):
        super().__init__()
        out = width * 4
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out)
        self.downsample = (nn.Sequential(nn.Conv2d(cin, out, 1, stride, bias=False),
                                         nn.BatchNorm2d(out))
                           if stride != 1 or cin != out else None)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        return F.relu(h + (x if self.downsample is None else self.downsample(x)))


_RESNET50_STAGES = [(3, 64), (4, 128), (6, 256), (3, 512)]


class ResNet50Features(_Frozen):
    """ResNet-50 trunk with taps at each stage's output (_resnet50,
    perceptual.py:285-302: layer_1 .. layer_4); eval-mode BatchNorm where
    the JAX package folds it (``_FoldedBN``)."""

    def __init__(self, layers: Sequence[str]):
        super().__init__()
        self.layers = list(layers)
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.depth = RESNET50_TAPS.index(sorted(self.layers)[-1]) + 1
        cin = 64
        for si, (blocks, width) in enumerate(_RESNET50_STAGES[:self.depth]):
            stage = []
            for bi in range(blocks):
                stage.append(Bottleneck(cin, width, 1 if si == 0 or bi else 2))
                cin = width * 4
            setattr(self, f"layer{si + 1}", nn.Sequential(*stage))
        self.skipped = tuple(f"layer{si + 1}." for si in range(self.depth, 4))
        self.freeze()

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        feats = {}
        for si in range(self.depth):
            x = getattr(self, f"layer{si + 1}")(x)
            if f"layer_{si + 1}" in self.layers:
                feats[f"layer_{si + 1}"] = x
        return feats


def robust_resnet50_state_dict(state_dict: Mapping) -> Dict:
    """The robust ResNet-50's ``ImageNet.pt`` (``{'model': {...}}`` with a
    ``module.model.`` prefix and the attacker's copy, perceptual.py:304-313)
    -> a flat resnet50 state_dict; a flat one passes through."""
    sd = state_dict
    if "model" in sd and hasattr(sd["model"], "items"):
        sd = sd["model"]
    flat = {}
    for k, v in sd.items():
        if k.startswith("module.model."):
            flat[k[len("module.model."):]] = v
        elif not k.startswith("module.attacker."):
            flat[k] = v
    return flat


class BasicConv2d(nn.Module):
    """torchvision's BasicConv2d: conv (no bias), BatchNorm (eps 1e-3), relu."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=0.001)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _pool_avg3(x):
    return F.avg_pool2d(x, 3, 1, 1)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_pool_avg3(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_pool_avg3(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(_pool_avg3(x))], 1)


class InceptionV3Features(_Frozen):
    """Inception-v3 trunk with the reference's four taps (_inception_v3,
    perceptual.py:255-281: pool_1 / pool_2 / mixed_6e / pool_3), torchvision's
    names; the input goes in as it is (no ``transform_input``)."""

    def __init__(self, layers: Sequence[str]):
        super().__init__()
        self.layers = list(layers)
        self.deepest = max(INCEPTION_TAPS.index(n) for n in self.layers)
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        stages = (
            (("Conv2d_3b_1x1", lambda: BasicConv2d(64, 80, 1)),
             ("Conv2d_4a_3x3", lambda: BasicConv2d(80, 192, 3))),
            (("Mixed_5b", lambda: InceptionA(192, 32)), ("Mixed_5c", lambda: InceptionA(256, 64)),
             ("Mixed_5d", lambda: InceptionA(288, 64)), ("Mixed_6a", lambda: InceptionB(288)),
             ("Mixed_6b", lambda: InceptionC(768, 128)),
             ("Mixed_6c", lambda: InceptionC(768, 160)),
             ("Mixed_6d", lambda: InceptionC(768, 160)),
             ("Mixed_6e", lambda: InceptionC(768, 192))),
            (("Mixed_7a", lambda: InceptionD(768)), ("Mixed_7b", lambda: InceptionE(1280)),
             ("Mixed_7c", lambda: InceptionE(2048))))
        self.stages = [[name for name, _ in stage] for stage in stages]
        for i, stage in enumerate(stages):
            for name, make in stage:
                if i < self.deepest:
                    setattr(self, name, make())
        self.skipped = tuple(f"{name}." for stage in self.stages[self.deepest:]
                             for name in stage)
        self.freeze()

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        feats = {}
        for i, name in enumerate(INCEPTION_TAPS[:self.deepest + 1]):
            if i:
                for mod in self.stages[i - 1]:
                    x = getattr(self, mod)(x)
                if name == "pool_2":
                    x = F.max_pool2d(x, 3, 2)
                elif name == "pool_3":  # AdaptiveAvgPool2d((1, 1)), the 1 x 1 kept
                    x = x.mean((2, 3), keepdim=True)
            if name in self.layers:
                feats[name] = x
        return feats


_VGGFACE_CONV_NAMES = ("conv1_1", "conv1_2", "conv2_1", "conv2_2",
                       "conv3_1", "conv3_2", "conv3_3",
                       "conv4_1", "conv4_2", "conv4_3",
                       "conv5_1", "conv5_2", "conv5_3")


def adaptive_avg_pool_2d(x: torch.Tensor, out_hw: Sequence[int]) -> torch.Tensor:
    """torch's AdaptiveAvgPool2d on NCHW: output cell (i, j) averages rows
    [floor(i H / oh), ceil((i + 1) H / oh)) and the columns alike."""
    return F.adaptive_avg_pool2d(x, tuple(out_hw))


class VGGFaceFeatures(_Frozen):
    """VGG-Face trunk (_vgg_face_dag, perceptual.py:316-343): the vgg16
    convs under ``vgg_face_dag``'s names (``conv1_1`` .. ``conv5_3``), a 7 x 7
    average pool, then ``fc6`` / ``fc7`` / ``fc8`` (2622 identities); the fc
    taps are 2-D."""

    def __init__(self, layers: Sequence[str]):
        super().__init__()
        self.layers = list(layers)
        cin, i = 3, 0
        for v in _VGG16_CFG:
            if v != "M":
                setattr(self, _VGGFACE_CONV_NAMES[i], nn.Conv2d(cin, v, 3, padding=1))
                cin, i = v, i + 1
        self.deepest = max(VGGFACE_TAPS.index(n) for n in self.layers)
        fcs = (("fc6", 512 * 7 * 7, 4096), ("fc7", 4096, 4096), ("fc8", 4096, 2622))
        for name, cin, cout in fcs:
            if VGGFACE_TAPS.index(name) <= self.deepest:
                setattr(self, name, nn.Linear(cin, cout))
        self.skipped = tuple(f"{name}." for name, _, _ in fcs
                             if VGGFACE_TAPS.index(name) > self.deepest)
        self.freeze()

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        deepest = self.deepest
        i = 0
        for v in _VGG16_CFG:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(getattr(self, _VGGFACE_CONV_NAMES[i])(x))
                i += 1
        x = adaptive_avg_pool_2d(x, (7, 7))
        feats = {"avgpool": x} if "avgpool" in self.layers else {}
        x = x.flatten(1)
        for name in VGGFACE_TAPS[1:deepest + 1]:
            x = getattr(self, name)(x) if name.startswith("fc") else F.relu(x)
            if name in self.layers:
                feats[name] = x
        return feats


PERCEPTUAL_NETWORKS = {
    "vgg19": VGG19Features,
    "vgg16": VGG16Features,
    "alexnet": AlexNetFeatures,
    "inception_v3": InceptionV3Features,
    "resnet50": ResNet50Features,
    "robust_resnet50": ResNet50Features,
    "vgg_face_dag": VGGFaceFeatures,
}
# state_dict keys of a full torchvision model that no trunk holds
_HEAD_PREFIXES = ("classifier.", "fc.", "AuxLogits.")


def load_trunk_state_dict(trunk: nn.Module, state_dict: Mapping, network: str = "") -> nn.Module:
    """A torchvision (or vgg_face_dag / robust ResNet-50) state_dict into a
    trunk with ``strict=True``, less what the trunk never runs: the
    classification head (``classifier.*``, ``fc.*`` of the torchvision
    models, ``AuxLogits.*``) and the layers past its deepest tap
    (``trunk.skipped``)."""
    sd = robust_resnet50_state_dict(state_dict) if network == "robust_resnet50" else state_dict
    if isinstance(sd, Mapping) and "state_dict" in sd:
        sd = sd["state_dict"]
    drop = tuple(trunk.skipped) + (() if isinstance(trunk, VGGFaceFeatures) else _HEAD_PREFIXES)
    sd = {k: v for k, v in sd.items() if not k.startswith(drop)}
    trunk.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()}, strict=True)
    return trunk


def make_trunk(network: str, layers: Sequence[str],
               state_dict: Optional[Mapping] = None) -> nn.Module:
    """``PERCEPTUAL_NETWORKS[network](layers)``, with ``state_dict`` loaded
    when given (random init otherwise)."""
    if network not in PERCEPTUAL_NETWORKS:
        raise ValueError(f"unknown perceptual network: {network} "
                         f"(have {sorted(PERCEPTUAL_NETWORKS)} + 'l1')")
    trunk = PERCEPTUAL_NETWORKS[network](layers)
    if state_dict is not None:
        load_trunk_state_dict(trunk, state_dict, network)
    return trunk


def apply_imagenet_normalization(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] NCHW -> imagenet-normalised (perceptual.py:359-366)."""
    mean = x.new_tensor(IMAGENET_MEAN).view(1, 3, 1, 1)
    std = x.new_tensor(IMAGENET_STD).view(1, 3, 1, 1)
    return ((x + 1) / 2 - mean) / std


def resize_bilinear(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """``jax.image.resize(x, ..., "bilinear")`` on NCHW: half-pixel centres,
    antialiased when either side shrinks."""
    size = tuple(int(s) for s in size)
    if tuple(x.shape[-2:]) == size:
        return x
    shrink = size[0] < x.shape[-2] or size[1] < x.shape[-1]
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False, antialias=shrink)


def _instance_norm(feat: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Affine-free instance norm over the spatial dims (perceptual.py:131-133)."""
    var, mean = torch.var_mean(feat, dim=(2, 3), keepdim=True, unbiased=False)
    return (feat - mean) * torch.rsqrt(var + eps)


def _gram(feat: torch.Tensor) -> torch.Tensor:
    b, c, h, w = feat.shape
    f = feat.reshape(b, c, h * w)
    return torch.bmm(f, f.transpose(1, 2)) / (h * w * c)


def _min_size(network: str, layers: Sequence[str]) -> int:
    """The smallest input the deepest tap survives: a smaller scale is
    skipped (JAX ``perceptual.py:801-829``)."""
    if network in ("vgg19", "vgg16"):
        cfg = _VGG19_CFG if network == "vgg19" else _VGG16_CFG
        taps = VGG19_TAPS if network == "vgg19" else VGG16_TAPS
        deepest, pools, conv_idx = max(taps[n] for n in layers), 0, 0
        for v in cfg:
            if v == "M":
                pools += 1
            elif conv_idx == deepest:
                break
            else:
                conv_idx += 1
        return 2 ** pools
    return {"alexnet": 64, "resnet50": 64, "robust_resnet50": 64, "inception_v3": 75,
            "vgg_face_dag": 224}.get(network, 0)


def default_layers(network: str, layers: Sequence[str]) -> list:
    """Callers passing the vgg default taps get each trunk's own taps."""
    if layers and layers[0].startswith("relu_1_"):
        return list({"alexnet": tuple(f"relu_{i}" for i in range(1, 6)),
                     "resnet50": RESNET50_TAPS, "robust_resnet50": RESNET50_TAPS,
                     "inception_v3": INCEPTION_TAPS,
                     "vgg_face_dag": VGGFACE_TAPS}.get(network, layers))
    return list(layers)


class PerceptualLoss(nn.Module):
    """The multi-scale perceptual loss of JAX ``render/perceptual.py:751``.

    ``state_dict``: the trunk's weights (torchvision layout); ``trunk``: an
    already built trunk to share (the trainer's two losses share one).
    Without either the trunk runs at torch's random init. ``forward(inp,
    target, mask=None)`` takes NCHW images in [-1, 1] (``mask`` (B, Cm, H,
    W)); the target branch is detached."""

    def __init__(self, layers: Sequence[str] = ("relu_1_1", "relu_2_1", "relu_3_1",
                                                "relu_4_1", "relu_5_1"),
                 num_scales: int = 4, use_style_loss: bool = False,
                 weight_style_to_perceptual: float = 0.0, network: str = "vgg19",
                 state_dict: Optional[Mapping] = None, trunk: Optional[nn.Module] = None,
                 resize: bool = False, weights: Optional[Sequence[float]] = None,
                 criterion: str = "l1", instance_normalized: bool = False):
        super().__init__()
        self.layers = default_layers(network, layers)
        self.num_scales = num_scales
        self.use_style_loss = use_style_loss
        self.weight_style = weight_style_to_perceptual
        self.network = network
        self.resize = resize  # bilinear to 224 first (perceptual.py:106-112)
        if weights is None:
            weights = [1.0] * len(self.layers)
        elif isinstance(weights, (int, float)):
            weights = [float(weights)]
        if len(weights) != len(self.layers):
            raise ValueError(f"number of weights ({len(weights)}) must equal number of "
                             f"layers ({len(self.layers)})")
        self.weights = [float(w) for w in weights]
        if criterion in ("l2", "mse"):
            self.criterion = F.mse_loss
        elif criterion == "l1":
            self.criterion = F.l1_loss
        else:
            raise ValueError(f"Criterion {criterion} is not recognized")
        self.instance_normalized = instance_normalized
        self.min_size = _min_size(network, self.layers)
        if network == "l1":
            self.model = None
        else:
            self.model = trunk if trunk is not None else make_trunk(network, self.layers,
                                                                    state_dict)

    def forward(self, inp: torch.Tensor, target: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.model is None:
            return (inp - target).abs().mean()
        inp = apply_imagenet_normalization(inp)
        target = apply_imagenet_normalization(target.detach())
        if self.resize:
            inp = resize_bilinear(inp, (224, 224))
            target = resize_bilinear(target, (224, 224))
        loss = inp.new_zeros(())
        style_loss = inp.new_zeros(())
        for scale in range(self.num_scales):
            if min(inp.shape[-2:]) < self.min_size:
                break  # the deepest tap would pool to an empty map
            fi = self.model(inp)
            with torch.no_grad():
                ft = self.model(target)
            for name, weight in zip(self.layers, self.weights):
                a, b = fi[name], ft[name]
                if a.ndim == 4:  # spatial taps only (VGG-Face's fc taps are 2-D)
                    if self.instance_normalized:
                        a, b = _instance_norm(a), _instance_norm(b)
                    if mask is not None:
                        m = resize_bilinear(mask, a.shape[-2:])
                        a, b = a * m, b * m
                loss = loss + weight * self.criterion(a, b)
                if self.use_style_loss and scale == 0 and fi[name].ndim == 4:
                    style_loss = style_loss + self.criterion(_gram(fi[name]), _gram(ft[name]))
            if scale != self.num_scales - 1:
                half = (inp.shape[-2] // 2, inp.shape[-1] // 2)
                inp, target = resize_bilinear(inp, half), resize_bilinear(target, half)
        if self.use_style_loss:
            return loss + self.weight_style * style_loss
        return loss
