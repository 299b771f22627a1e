import os
import sys

# Each xdist worker's torch, OpenBLAS and OpenCV would size their thread pools to every core, so six
# workers would spin ~48 threads on 8 cores: share the cores out, through variables child processes inherit.
if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    _budget = str(max(1, len(os.sched_getaffinity(0)) // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))
    for _name in ("OMP_NUM_THREADS", "OPENCV_FOR_THREADS_NUM"):
        os.environ.setdefault(_name, _budget)
    if "numpy" in sys.modules:  # jaxtyping's pytest plugin imports it first: its OpenBLAS read no variable
        from threadpoolctl import threadpool_limits

        threadpool_limits(int(os.environ["OMP_NUM_THREADS"]))
