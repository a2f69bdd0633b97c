from .ms_deform_attn import ms_deform_attn, ms_deform_attn_torch

__all__ = ["ms_deform_attn", "ms_deform_attn_torch"]
