"""The sharded mosaic path (port of ``obia_tpu/parallel``): a logical mesh
of raster shards (:mod:`.mesh`), halo exchange (:mod:`.halo`), the sharded
segmentation and statistics stages (:mod:`.sharded`, :mod:`.glcm_sharded`)
and the mosaic pipeline (:mod:`.mosaic`)."""
