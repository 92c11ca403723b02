"""PIRender's FaceGenerator (reference ``Pirender/generators/face_model.py``
and ``base_function.py``), on NCHW tensors.

Counterpart of ``dyadic_interaction_modeling_tpu/render/generator.py``:

* ``MappingNet``: 1-D convs over a coefficient window -> descriptor, with the
  DIM modification's ``pre`` 1x1 conv (flame_coeff_nc -> coeff_nc,
  face_model.py:39-67),
* ``WarpingNet``: ADAIN hourglass -> 2-channel flow -> bilinear warp
  (face_model.py:71-105),
* ``EditingNet``: FineEncoder over [input, warp] + ADAIN FineDecoder
  (face_model.py:109-134).

Modules carry the reference's names (``mapping_net.first.0``,
``warpping_net.hourglass.encoder.encoder{i}.conv_0``,
``editing_net.decoder.res{i}.res{b}.conv1``, ...), so a reference PIRender
state_dict (``net_G_ema``) loads with ``strict=True``. With ``use_spect`` the
twelve conv sites the reference passes through ``spectral_norm`` are wrapped
in ``torch.nn.utils.spectral_norm`` (``weight_orig`` / ``weight_u`` /
``weight_v``); in eval their weight is ``W / (u^T W v)`` from the stored
vectors.

Reference quirks, kept: ``FineADAINResBlock`` computes its second branch from
``conv2(x)``, not ``conv2(dx)`` (base_function.py:344-347); the decoder
upsamples nearest x2; ``LayerNorm2d`` normalises over (C, H, W) jointly with a
per-channel affine; the LeakyReLU slope is 0.1.

Mixed precision (the JAX package's serving config, ``FaceGenerator(dtype,
warp_dtype)``): the mapping and editing nets run under ``torch.autocast`` in
``dtype``, the warping net in ``warp_dtype`` (``dtype`` when None); the
statistics of ``LayerNorm2d`` and ``ADAIN`` are always taken in fp32, and the
flow and the warp are fp32.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Mapping, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .flow import convert_flow_to_deformation, warp_image

SLOPE = 0.1


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, SLOPE)


def _sn(conv: nn.Module, use_spect: bool) -> nn.Module:
    """``spectral_norm(conv, use_spect)`` (base_function.py:151-156)."""
    return nn.utils.spectral_norm(conv) if use_spect else conv


def _conv(cin: int, cout: int, k: int, use_spect: bool = False) -> nn.Module:
    return _sn(nn.Conv2d(cin, cout, k, 1, k // 2), use_spect)


def _autocast(device: torch.device, dtype: torch.dtype):
    if dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=dtype)


def _normalize(x: torch.Tensor, dims, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """(x - mean) / sqrt(var + 1e-5) * weight + bias, the statistics over
    ``dims`` of each sample in fp32 (biased variance), then one pass over x:
    the affine folds the statistics in (x * scale + shift). ``F.layer_norm``
    over (C, H, W) gives each sample one block of threads: at a batch of 8
    on an H100 it took 62 ms of a 76 ms TF32 batch at 256 x 256 (PERF.md)."""
    var, mean = torch.var_mean(x.float(), dim=dims, keepdim=True, correction=0)
    scale = torch.rsqrt(var + 1e-5) * weight
    return torch.addcmul((bias - mean * scale).to(x.dtype), x, scale.to(x.dtype))


class LayerNorm2d(nn.Module):
    """Normalise over (C, H, W) per sample, then a per-channel affine
    (base_function.py:11-29); statistics in fp32."""

    def __init__(self, n_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n_out, 1, 1))
        self.bias = nn.Parameter(torch.zeros(n_out, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _normalize(x, (1, 2, 3), self.weight, self.bias)


class ADAIN(nn.Module):
    """Instance norm modulated by the descriptor (base_function.py:159-190);
    statistics in fp32."""

    def __init__(self, norm_nc: int, feature_nc: int):
        super().__init__()
        self.mlp_shared = nn.Sequential(nn.Linear(feature_nc, 128), nn.ReLU())
        self.mlp_gamma = nn.Linear(128, norm_nc)
        self.mlp_beta = nn.Linear(128, norm_nc)

    def forward(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        h = self.mlp_shared(z.reshape(z.shape[0], -1))
        gamma = self.mlp_gamma(h)[:, :, None, None]
        return _normalize(x, (2, 3), 1 + gamma, self.mlp_beta(h)[:, :, None, None])


class ADAINEncoderBlock(nn.Module):
    def __init__(self, input_nc: int, output_nc: int, feature_nc: int, use_spect: bool):
        super().__init__()
        self.conv_0 = _sn(nn.Conv2d(input_nc, output_nc, 4, 2, 1), use_spect)
        self.conv_1 = _conv(output_nc, output_nc, 3, use_spect)
        self.norm_0 = ADAIN(input_nc, feature_nc)
        self.norm_1 = ADAIN(output_nc, feature_nc)

    def forward(self, x, z):
        x = self.conv_0(lrelu(self.norm_0(x, z)))
        return self.conv_1(lrelu(self.norm_1(x, z)))


class ADAINDecoderBlock(nn.Module):
    """Upsampling x2 by transposed convs (k 3, stride 2, padding 1, output
    padding 1), with a learned shortcut (base_function.py:93-148)."""

    def __init__(self, input_nc: int, output_nc: int, hidden_nc: int, feature_nc: int,
                 use_spect: bool):
        super().__init__()
        self.conv_0 = _conv(input_nc, hidden_nc, 3, use_spect)
        self.conv_1 = _sn(nn.ConvTranspose2d(hidden_nc, output_nc, 3, 2, 1, 1), use_spect)
        self.conv_s = _sn(nn.ConvTranspose2d(input_nc, output_nc, 3, 2, 1, 1), use_spect)
        self.norm_0 = ADAIN(input_nc, feature_nc)
        self.norm_1 = ADAIN(hidden_nc, feature_nc)
        self.norm_s = ADAIN(input_nc, feature_nc)

    def forward(self, x, z):
        s = self.conv_s(lrelu(self.norm_s(x, z)))
        h = self.conv_0(lrelu(self.norm_0(x, z)))
        return s + self.conv_1(lrelu(self.norm_1(h, z)))


class _ADAINEncoder(nn.Module):
    def __init__(self, image_nc, feature_nc, ngf, img_f, layers, use_spect):
        super().__init__()
        self.layers = layers
        self.input_layer = nn.Conv2d(image_nc, ngf, 7, 1, 3)
        for i in range(layers):
            cin = min(ngf * 2 ** i, img_f)
            cout = min(ngf * 2 ** (i + 1), img_f)
            setattr(self, f"encoder{i}", ADAINEncoderBlock(cin, cout, feature_nc, use_spect))

    def forward(self, x, z):
        out = self.input_layer(x)
        skips = [out]
        for i in range(self.layers):
            out = getattr(self, f"encoder{i}")(out, z)
            skips.append(out)
        return skips


class _ADAINDecoder(nn.Module):
    def __init__(self, feature_nc, ngf, img_f, encoder_layers, decoder_layers, use_spect):
        super().__init__()
        self.levels = list(range(encoder_layers - decoder_layers, encoder_layers))[::-1]
        for i in self.levels:
            cin = min(ngf * 2 ** (i + 1), img_f)
            cin = cin * 2 if i != encoder_layers - 1 else cin
            cout = min(ngf * 2 ** i, img_f)
            setattr(self, f"decoder{i}",
                    ADAINDecoderBlock(cin, cout, cout, feature_nc, use_spect))
        self.output_nc = cout * 2

    def forward(self, skips, z):
        out = skips.pop()
        for i in self.levels:
            out = torch.cat([getattr(self, f"decoder{i}")(out, z), skips.pop()], dim=1)
        return out


class ADAINHourglass(nn.Module):
    """Encoder-decoder with skip concatenation (base_function.py:31-90)."""

    def __init__(self, image_nc: int, feature_nc: int, ngf: int = 32, img_f: int = 256,
                 encoder_layers: int = 5, decoder_layers: int = 3, use_spect: bool = False):
        super().__init__()
        self.encoder = _ADAINEncoder(image_nc, feature_nc, ngf, img_f, encoder_layers,
                                     use_spect)
        self.decoder = _ADAINDecoder(feature_nc, ngf, img_f, encoder_layers, decoder_layers,
                                     use_spect)
        self.output_nc = self.decoder.output_nc

    def forward(self, x, z):
        return self.decoder(self.encoder(x, z), z)


class MappingNet(nn.Module):
    """Coefficient window (B, flame_coeff_nc, T) -> descriptor (B, descriptor_nc):
    ``pre`` 1x1 conv, a k=7 conv, then ``layer`` k=3 dilation-3 convs with
    residual crops (all VALID), the mean over time."""

    def __init__(self, flame_coeff_nc: int = 58, coeff_nc: int = 73,
                 descriptor_nc: int = 256, layer: int = 3):
        super().__init__()
        self.layer = layer
        self.pre = nn.Conv1d(flame_coeff_nc, coeff_nc, 1)
        self.first = nn.Sequential(nn.Conv1d(coeff_nc, descriptor_nc, 7))
        for i in range(layer):
            setattr(self, f"encoder{i}", nn.Sequential(
                nn.LeakyReLU(SLOPE), nn.Conv1d(descriptor_nc, descriptor_nc, 3, dilation=3)))

    def forward(self, coeffs: torch.Tensor) -> torch.Tensor:
        min_t = 7 + 6 * self.layer  # k=7 VALID + layer x (k=3, dilation 3)
        if coeffs.shape[-1] < min_t:
            raise ValueError(
                f"MappingNet window length {coeffs.shape[-1]} < {min_t}: the VALID "
                f"convolutions need semantic_radius >= {(min_t - 1) // 2} "
                f"(the reference's shipped semantic_radius=1 config would crash "
                f"its own MappingNet the same way)")
        h = self.first(self.pre(coeffs))
        for i in range(self.layer):
            h = getattr(self, f"encoder{i}")(h) + h[:, :, 3:-3]
        return h.mean(dim=2)


class WarpingNet(nn.Module):
    def __init__(self, image_nc: int = 3, descriptor_nc: int = 256, base_nc: int = 32,
                 max_nc: int = 256, encoder_layer: int = 5, decoder_layer: int = 3,
                 use_spect: bool = False):
        super().__init__()
        self.hourglass = ADAINHourglass(image_nc, descriptor_nc, base_nc, max_nc,
                                        encoder_layer, decoder_layer, use_spect)
        nc = self.hourglass.output_nc
        self.flow_out = nn.Sequential(LayerNorm2d(nc), nn.LeakyReLU(SLOPE),
                                      nn.Conv2d(nc, 2, 7, 1, 3))

    def forward(self, input_image, descriptor) -> Dict[str, torch.Tensor]:
        # the flow and the sampling grid stay fp32: bf16 coordinates on a
        # 256-px grid are ~1 px coarse
        flow = self.flow_out(self.hourglass(input_image, descriptor)).float()
        deformation = convert_flow_to_deformation(flow)
        return {"flow_field": flow,
                "warp_image": warp_image(input_image.float(), deformation)}


class _Block(nn.Module):
    """conv -> LayerNorm2d -> LeakyReLU as the reference's ``model``
    Sequential (FirstBlock2d, DownBlock2d, UpBlock2d, Jump)."""

    def __init__(self, cin, cout, k, use_spect):
        super().__init__()
        self.model = nn.Sequential(_conv(cin, cout, k, use_spect), LayerNorm2d(cout),
                                   nn.LeakyReLU(SLOPE))

    def forward(self, x):
        return self.model(x)


class FineADAINResBlock(nn.Module):
    """Quirk kept: the output branch reads ``conv2(x)``, not ``conv2(dx)``."""

    def __init__(self, nc: int, feature_nc: int, use_spect: bool):
        super().__init__()
        self.conv1 = _conv(nc, nc, 3, use_spect)
        self.conv2 = _conv(nc, nc, 3, use_spect)
        self.norm1 = ADAIN(nc, feature_nc)
        self.norm2 = ADAIN(nc, feature_nc)

    def forward(self, x, z):
        # the reference's first branch, lrelu(norm1(conv1(x))), never reaches
        # the output, so it is not computed (XLA drops it from the JAX
        # program too); conv1 and norm1 stay for the state_dict
        return self.norm2(self.conv2(x), z) + x


class _FineEncoder(nn.Module):
    def __init__(self, image_nc, ngf, img_f, layers, use_spect):
        super().__init__()
        self.layers = layers
        self.first = _Block(image_nc, ngf, 7, use_spect)
        for i in range(layers):
            setattr(self, f"down{i}", _Block(min(ngf * 2 ** i, img_f),
                                             min(ngf * 2 ** (i + 1), img_f), 3, use_spect))

    def forward(self, x):
        out = self.first(x)
        skips = [out]
        for i in range(self.layers):
            out = F.avg_pool2d(getattr(self, f"down{i}")(out), 2)
            skips.append(out)
        return skips


class _ResBlocks(nn.Module):
    def __init__(self, num_blocks, nc, feature_nc, use_spect):
        super().__init__()
        self.num_blocks = num_blocks
        for b in range(num_blocks):
            setattr(self, f"res{b}", FineADAINResBlock(nc, feature_nc, use_spect))

    def forward(self, x, z):
        for b in range(self.num_blocks):
            x = getattr(self, f"res{b}")(x, z)
        return x


class _FinalBlock(nn.Module):
    def __init__(self, cin, cout, use_spect):
        super().__init__()
        self.model = nn.Sequential(_conv(cin, cout, 7, use_spect))

    def forward(self, x):
        return torch.tanh(self.model(x))


class _FineDecoder(nn.Module):
    def __init__(self, image_nc, feature_nc, ngf, img_f, layers, num_res_blocks, use_spect):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            cin, cout = min(ngf * 2 ** (i + 1), img_f), min(ngf * 2 ** i, img_f)
            setattr(self, f"up{i}", _Block(cin, cout, 3, use_spect))
            setattr(self, f"res{i}", _ResBlocks(num_res_blocks, cin, feature_nc, use_spect))
            setattr(self, f"jump{i}", _Block(cout, cout, 3, use_spect))
        self.final = _FinalBlock(min(ngf, img_f), image_nc, use_spect)

    def forward(self, skips, z):
        out = skips.pop()
        for i in reversed(range(self.layers)):
            out = getattr(self, f"res{i}")(out, z)
            out = getattr(self, f"up{i}")(F.interpolate(out, scale_factor=2, mode="nearest"))
            out = getattr(self, f"jump{i}")(skips.pop()) + out
        return self.final(out)


class EditingNet(nn.Module):
    def __init__(self, image_nc: int = 3, descriptor_nc: int = 256, layer: int = 3,
                 base_nc: int = 64, max_nc: int = 256, num_res_blocks: int = 2,
                 use_spect: bool = False):
        super().__init__()
        self.encoder = _FineEncoder(image_nc * 2, base_nc, max_nc, layer, use_spect)
        self.decoder = _FineDecoder(image_nc, descriptor_nc, base_nc, max_nc, layer,
                                    num_res_blocks, use_spect)

    def forward(self, input_image, warp_image, descriptor):
        return self.decoder(self.encoder(torch.cat([input_image, warp_image], dim=1)),
                            descriptor)


class FaceGenerator(nn.Module):
    """mapping -> warping -> editing (face_model.py:15-35).

    ``forward(input_image (B, 3, H, W), driving_source (B, flame_coeff_nc, T),
    stage=None)`` -> {'flow_field' (B, 2, H/4, W/4), 'warp_image', and unless
    ``stage == "warp"`` 'fake_image' (B, 3, H, W)}. Render in eval mode: with
    ``use_spect`` a module in training mode steps the power iteration."""

    def __init__(self, flame_coeff_nc: int = 58, coeff_nc: int = 73,
                 descriptor_nc: int = 256, mapping_layers: int = 3,
                 use_spect: bool = False, dtype: torch.dtype = torch.float32,
                 warp_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.warp_dtype = warp_dtype or dtype
        self.mapping_net = MappingNet(flame_coeff_nc, coeff_nc, descriptor_nc, mapping_layers)
        self.warpping_net = WarpingNet(descriptor_nc=descriptor_nc, use_spect=use_spect)
        self.editing_net = EditingNet(descriptor_nc=descriptor_nc, use_spect=use_spect)

    def forward(self, input_image: torch.Tensor, driving_source: torch.Tensor,
                stage: Optional[str] = None) -> Dict[str, torch.Tensor]:
        dev = input_image.device
        with _autocast(dev, self.dtype):
            # fp32 out: each net casts it to its own compute dtype
            descriptor = self.mapping_net(driving_source).float()
        with _autocast(dev, self.warp_dtype):
            output = self.warpping_net(input_image, descriptor)
        if stage != "warp":
            with _autocast(dev, self.dtype):
                output["fake_image"] = self.editing_net(input_image, output["warp_image"],
                                                        descriptor)
        return output


def face_generator_from_state_dict(state_dict: Mapping[str, torch.Tensor],
                                   **kwargs) -> FaceGenerator:
    """A ``FaceGenerator`` with the widths of a reference-layout state_dict
    (coefficient widths, descriptor width, mapping layers, spectral norm),
    its weights loaded with ``strict=True``; ``kwargs`` (``dtype``,
    ``warp_dtype``) pass through."""
    pre = state_dict["mapping_net.pre.weight"]
    layers = sum(1 for k in state_dict
                 if k.startswith("mapping_net.encoder") and k.endswith(".1.weight"))
    model = FaceGenerator(flame_coeff_nc=pre.shape[1], coeff_nc=pre.shape[0],
                          descriptor_nc=state_dict["mapping_net.first.0.weight"].shape[0],
                          mapping_layers=layers,
                          use_spect=any(k.endswith(".weight_orig") for k in state_dict),
                          **kwargs)
    model.load_state_dict(state_dict, strict=True)
    return model
