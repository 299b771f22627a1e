"""Host-side data pipelines of the port: dataset-dict generators, the
detection loader, and the MOT / KITTI-MOTS loaders of association-head
training (counterparts of the JAX reference's ``data`` package; COWC waits,
see ``ROADMAP.md``)."""
