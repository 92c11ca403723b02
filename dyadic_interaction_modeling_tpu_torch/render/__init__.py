"""PIRender's neural renderer, the inference side.

Counterpart of ``dyadic_interaction_modeling_tpu/render/`` (the reference's
``Pirender/``): ``FaceGenerator`` (mapping, warping and editing nets) on NCHW
tensors under the reference's module names, the flow warp, the VoxCeleb LMDB
and coefficient-directory readers, batch and video inference, and the PNG
codec that lets the path run without Pillow (``image_io``). Coefficients
enter as (B, C, T) windows, as in the reference.
"""

from .flow import convert_flow_to_deformation, warp_image
from .generator import EditingNet, FaceGenerator, MappingNet, WarpingNet

__all__ = ["EditingNet", "FaceGenerator", "MappingNet", "WarpingNet",
           "convert_flow_to_deformation", "warp_image"]
