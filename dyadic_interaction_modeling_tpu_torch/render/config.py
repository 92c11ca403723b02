"""PIRender's nested config (reference ``Pirender/config.py:10-214``).

A copy of ``dyadic_interaction_modeling_tpu/render/config.py`` on the port's
``CfgNode``, which the port keeps so it never imports the JAX package: the
defaults, a YAML file over them (PyYAML needed, imported only then) and a
``logdir`` named by date.
"""

from __future__ import annotations

import os
from datetime import datetime

from ..config import CfgNode

RENDER_DEFAULTS = dict(
    distributed=False,
    image_to_tensorboard=False,
    snapshot_save_iter=625,
    snapshot_save_epoch=20,
    snapshot_save_start_iter=200,
    snapshot_save_start_epoch=1,
    image_save_iter=625,
    max_epoch=200,
    logging_iter=100,
    results_dir="./eval_results",
    gen_optimizer=dict(
        type="adam", lr=0.0001, adam_beta1=0.5, adam_beta2=0.999,
        lr_policy=dict(iteration_mode=True, type="step", step_size=300000,
                       gamma=0.2),
    ),
    trainer=dict(
        pretrain_warp_iteration=1,
        loss_weight=dict(weight_perceptual_warp=2.5, weight_perceptual_final=4),
        vgg_param_warp=dict(network="vgg19",
                            layers=["relu_1_1", "relu_2_1", "relu_3_1",
                                    "relu_4_1", "relu_5_1"],
                            use_style_loss=False, num_scales=4),
        vgg_param_final=dict(network="vgg19",
                             layers=["relu_1_1", "relu_2_1", "relu_3_1",
                                     "relu_4_1", "relu_5_1"],
                             use_style_loss=True, num_scales=4,
                             style_to_perceptual=250),
        init=dict(type="normal", gain=0.02),
    ),
    gen=dict(param=dict(
        mapping_net=dict(coeff_nc=56, descriptor_nc=256, layer=3),
        warpping_net=dict(encoder_layer=5, decoder_layer=3, base_nc=32),
        editing_net=dict(layer=3, num_res_blocks=2, base_nc=64),
        common=dict(image_nc=3, descriptor_nc=256, max_nc=256, use_spect=False),
    )),
    data=dict(resolution=256, semantic_radius=13),
)


def _merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in (override or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def load_render_config(path: str = None, name: str = "face") -> CfgNode:
    """YAML over the defaults -> nested CfgNode with a logdir
    (config.py:67-115)."""
    override = {}
    if path:
        try:
            import yaml
        except ImportError as e:
            raise ImportError("a render config file needs PyYAML (the 'yaml' module), "
                              "which is not installed") from e
        with open(path) as f:
            override = yaml.safe_load(f) or {}
    cfg = CfgNode(_merge(RENDER_DEFAULTS, override))
    date_uid = datetime.now().strftime("%Y_%m%d_%H%M_%S")
    cfg.logdir = os.path.join("result", f"{name}_{date_uid}")
    return cfg
