"""PyTorch and CUDA port of odise_tpu (open-vocabulary panoptic segmentation).

The JAX package ``odise_tpu`` is the reference; this package imports none of it.
"""
