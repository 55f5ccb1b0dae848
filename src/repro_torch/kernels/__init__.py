"""Hand-written Hopper attention kernels (csrc/), their plain versions, and
the ops that compile masks for them."""
