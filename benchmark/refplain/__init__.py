"""The benchmark's plain reference: a frozen copy of the plain PyTorch
versions of the measured package (``apse_uav_torch``), as they stood when
the benchmark was written, cut to what the cells run: the two-pass and
one-pass ArUco fronts, pose and scan, and the R-FPN tracker at inference
with the embeddings association.  Training, C4 and checkpoint surgery are
not here.

Modules keep the measured package's layout and names (``aruco/pipeline.py``
here is ``aruco/pipeline.py`` there), so each counterpart is easy to find.
The five kernel wrappers (``aruco/cuda_labeling.py``,
``aruco/cuda_proposals.py``, ``preproc/cuda_pool.py``,
``preproc/cuda_remap.py``, ``dcnn/cuda_auction.py``) are replaced by their
plain versions on every device: nothing here builds or launches a
hand-written kernel.  Nothing here imports the measured package, JAX or the
JAX package; later changes to the measured package do not reach this copy.
"""
