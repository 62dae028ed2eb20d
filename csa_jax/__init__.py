"""csa_jax — a cyclic multiple-sequence alignment framework in JAX.

A from-scratch re-design of the capabilities of fjdf/CSA ("Multiple Circular
Sequence Aligner") for accelerators (a GPU; CPU for tests):

* the generalized cyclic suffix tree (reference: source/gencycsuffixtrees.c)
  is replaced by a **generalized cyclic suffix-array engine** built from
  prefix-doubling rank sorts, capped LCPs, and lcp-interval enumeration —
  all argsort/gather/segment primitives that map directly onto XLA;
* the rotation analysis (reference: source/csamsa.c:69-308) becomes a
  vectorized filter cascade over the enumerated block intervals plus an
  exact host-side chain-assembly emulation;
* the progressive profile DP (reference: source/dynamicprogramming.c) becomes
  a batched anti-diagonal wavefront kernel (JAX / Pallas);
* scaling is expressed with jax.sharding meshes instead of any message
  passing.

Public entry points live in :mod:`csa_jax.cli` and the subpackage APIs.
"""

__version__ = "0.1.0"
