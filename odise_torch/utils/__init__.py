"""Events, writers and logging (counterpart of ``odise_tpu/utils``)."""
