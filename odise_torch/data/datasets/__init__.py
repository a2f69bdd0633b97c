"""Dataset registrations (counterpart of ``odise_tpu/data/datasets``): COCO
panoptic with captions, ADE20K, Pascal VOC and Context, Mapillary Vistas
and COCO-Stuff-10k, each under ``get_dataset_root()``; and the label files
and category tables they name (``openseg_labels/``, ``metadata/``)."""
