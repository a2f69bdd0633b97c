"""Label files, transforms and synthetic records (counterpart of
``odise_tpu/data``)."""
