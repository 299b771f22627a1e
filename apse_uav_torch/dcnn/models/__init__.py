"""Mask R-CNN (R-FPN and R-C4) and the re-ID head as ``nn.Module``s with detectron2 names."""
