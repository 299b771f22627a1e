"""The benchmark's own code: finding a cell's files by name, the chip and
JAX guards, clocks, the profiler's reading, the yardsticks (peaks, FLOPs,
kernel bytes and operations), the scene, the seeded weights, the plain
reference's engines and the comparison that decides ``correct``.

Nothing here imports the measured package at module level; the drivers in
``benchmark/drivers/`` import it inside their functions, after the chip check.
"""
