"""Host-side data pipelines of the port: dataset-dict generators, the
detection loader, the MOT / KITTI-MOTS loaders of association-head training
and the COWC ROI-feature loader (counterparts of the JAX reference's
``data`` package)."""
