"""Post-processing and export: counterpart of
``dyadic_interaction_modeling_tpu/postprocess/``."""

from .smoothing import export_emoca_dirs, merge_biwi_to_emoca, smooth_logits_matrix

__all__ = ["smooth_logits_matrix", "export_emoca_dirs", "merge_biwi_to_emoca"]
