"""Dataset preparation scripts (counterparts of the ``datasets/prepare_*.py``
scripts that import the JAX package), run as ``python -m
odise_torch.prepare.<name> [root]`` with ``root`` defaulting to
``$DETECTRON2_DATASETS``, else ``datasets``. Each writes what its JAX
script writes, to the same paths, reading and writing label files with
``data.image_io`` (no PIL)."""
