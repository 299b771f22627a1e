"""The DCNN tracking method on PyTorch: Mask R-CNN (ResNet-FPN) detection,
re-ID embeddings and gated-auction association (``track_uav``).

Counterpart of the JAX reference's ``dcnn`` package, module for module.  Its
convolutions and matrix products are library calls (cuDNN, cuBLAS); the
association's gated auction is a hand-written kernel on the card
(``cuda_auction``); ROIAlign, NMS and the track store are plain PyTorch on
fixed shapes.
"""
