"""PIRender's neural renderer.

Counterpart of ``dyadic_interaction_modeling_tpu/render/`` (the reference's
``Pirender/``): ``FaceGenerator`` (mapping, warping and editing nets) on NCHW
tensors under the reference's module names, the flow warp, the datasets (the
VoxCeleb LMDB, the ViCo frame directories, coefficient directories), batch
and video inference, the PNG codec that lets the path run without Pillow
(``image_io``), and the training side: the perceptual trunks and loss
(``perceptual``), the LPIPS-style metric (``metrics``) and ``FaceTrainer``
(``trainer``). Coefficients enter as (B, C, T) windows, as in the
reference. The JAX package's ``import_torch`` has no counterpart: the port
keeps the reference's layout, so a reference state_dict loads directly.
"""

from .flow import convert_flow_to_deformation, warp_image
from .generator import EditingNet, FaceGenerator, MappingNet, WarpingNet

__all__ = ["EditingNet", "FaceGenerator", "MappingNet", "WarpingNet",
           "convert_flow_to_deformation", "warp_image"]
