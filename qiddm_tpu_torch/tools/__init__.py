"""The card's ceiling probes (counterparts of the TPU's ``tools/`` probes).

* ``python -m qiddm_tpu_torch.tools.vpu_ceiling``: the float32 FMA rate at
  the gate kernels' (d, B) geometry;
* ``python -m qiddm_tpu_torch.tools.wide_probe``: shared memory a block
  and a cluster can hold, the cost of a transpose and of a relayout, the
  float32 group product of a 20-wire state, and the middle-axis
  contraction.

Both run on the card unless given ``--device cpu`` (the kernels' plain
versions, for the tests). ``probe_kernels`` holds the kernels' wrappers.
"""
