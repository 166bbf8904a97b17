"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (used for CPU tensors and as the reference the card is held to).

Each module binds one or more ``csrc/<name>.cu`` sources (CUDA C++ for
``sm_90a``, built by `build` at first launch and loaded with ctypes) and
dispatches on the tensors' device: a CUDA tensor launches the kernel, a
CPU tensor runs the plain version.  Every wrapper counts its launches in
``<wrapper>.launches`` (`count_launch`: the ranks of a flow-sharded run
launch from threads of their own).

- `spray_select`: the per-packet Whack-a-Mole path choice (the Pallas
  ``spray_select_pallas``); `spray_select` / `spray_select_rows`, plain
  `spray_select_plain` / `spray_select_rows_plain`.
- `lt_encode`: LT fountain encoding, a gather-XOR of source rows (the
  Pallas ``lt_encode_pallas``); plain `lt_encode_plain`.
- `link_fold`: the shared fabric's ordered per-link sums over a CSR of
  the routing matrix (no Pallas counterpart: the reference's XLA
  scatter-add); plain `link_fold_plain`.
- `flash_attention`: causal / windowed GQA attention (the Pallas
  ``flash_attention_pallas``), with its lse (`flash_attention_with_lse`)
  and its gradient (`flash_attention_bwd`, which the reference cannot
  take of its kernel); plain `flash_attention_plain` /
  `flash_attention_bwd_plain`.
- `flash_decode`: one query over a KV cache, split-K with an lse merge
  (the Pallas ``flash_decode_pallas``); plain `flash_decode_plain`.
- `tma`: what a tensor map reads in place, and the aligning copy, shared
  by the two attention kernels; `build`: nvcc and the loader.
"""

import threading

_COUNT_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """``wrapper.launches += 1`` under a lock, so no thread's count is lost."""
    with _COUNT_LOCK:
        wrapper.launches += 1
