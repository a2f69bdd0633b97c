"""Label files, datasets, file readers, transforms and synthetic records
(counterpart of ``odise_tpu/data``). Importing the package registers the
five dataset families under ``get_dataset_root()``, as the JAX package's
import does."""

from .datasets import register_coco  # noqa: F401
from .datasets import register_ade20k  # noqa: F401
from .datasets import register_pascal  # noqa: F401
from .datasets import register_mapillary  # noqa: F401
from .datasets import register_coco_stuff  # noqa: F401
