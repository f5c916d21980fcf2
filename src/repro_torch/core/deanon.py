"""KernelZero — de-anonymization of Arrow memory (paper §4.2.1).

The kernel module exposes two calls:

    new_file()                      -> tmpfs file to receive anonymous memory
    deanon(file_id, addr, len)      -> append [addr, addr+len) to the file
                                       *without copying* (ownership transfer)

This user-space implementation preserves the contract and the cost model:

  * whole pages are transferred by reference (zero copy) — here, the store
    file's extent holds a read-only view of the caller's numpy memory;
  * partial head/tail pages are *really copied* (``partial_page_bytes``);
  * memory that has been de-anonymized is made immutable
    (``writeable = False``) — the paper requires the producing process to
    never modify transferred data (§4.2.1, last ¶);
  * ``direct_swap``: when the source region was already swapped out, the
    swap entry is moved into the tmpfs file without any disk I/O.  Without
    this optimization the pages must first be swapped in (real read).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np

from .buffers import (PAGE, AnonRegion, BufferStore, Cgroup, StoreFile,
                      alloc_aligned)


class KernelZero:
    """User-space stand-in for the KernelZero Linux module."""

    def __init__(self, store: BufferStore):
        self.store = store

    # -- interface 1 -------------------------------------------------------
    def new_file(self, owner: Cgroup, label: str = "") -> StoreFile:
        return self.store.new_file(owner, label)

    # -- interface 2 -------------------------------------------------------
    def deanon(self, file: StoreFile,
               src: Union[np.ndarray, AnonRegion],
               direct_swap: bool = True) -> Tuple[int, int]:
        """Move ``src`` into ``file`` (append) without copying.

        Returns (offset, length) of the appended range.
        """
        region: Optional[AnonRegion] = None
        if isinstance(src, AnonRegion):
            region = src
            if region.swapped:
                return self._deanon_swapped(file, region, direct_swap)
            arr = region.array
        else:
            arr = src
        if isinstance(arr, np.ndarray) and arr.flags["C_CONTIGUOUS"]:
            # best-effort enforcement of the §4.2.1 contract on the caller's
            # own handle (other pre-existing views cannot be frozen from
            # user space; the kernel version freezes the physical pages)
            arr.flags.writeable = False
        arr = np.ascontiguousarray(arr).view(np.uint8).reshape(-1)
        n = arr.nbytes
        if n == 0:
            return file.length, 0

        # page-granularity cost model: copy partial head/tail pages for real
        addr = arr.__array_interface__["data"][0]
        head = (-addr) % PAGE
        head = min(head, n)
        tail = (addr + n) % PAGE if n > head else 0
        tail = min(tail, n - head)
        partial = head + tail
        if partial:
            # the kernel would memcpy these bytes into fresh pages; do it
            if head:
                _ = arr[:head].copy()
            if tail:
                _ = arr[n - tail:].copy()
            self.store.stats.partial_page_bytes += partial
            self.store.stats.bytes_copied += partial

        # ownership-of-charge transfer: the sandbox's anonymous charge moves
        # to the file owner's cgroup (tmpfs charging rules, paper §4.1)
        if region is not None:
            keep = region.array
            region.release()
            arr = keep.view(np.uint8).reshape(-1)

        off = file.append_extent(arr)
        self.store.stats.bytes_deanon += n - partial
        return off, n

    def _deanon_swapped(self, file: StoreFile, region: AnonRegion,
                        direct_swap: bool) -> Tuple[int, int]:
        n = region.nbytes
        if direct_swap:
            # move the swap entry into the tmpfs file: zero disk I/O
            off = file.append_extent(None, swap_path=region.swap_path,
                                     length=n)
            self.store.stats.direct_swap_bytes += n
            region.swap_path = None
            region.swapped = False
            region.cgroup.swap_charged -= n
            region.array = None  # type: ignore[assignment]
            try:
                self.store.anon_regions.remove(region)
            except ValueError:
                pass
            return off, n
        # naive path: swap in first (real disk read), then transfer
        region.swap_in(self.store)
        return self.deanon(file, region, direct_swap=False)

    # -- baseline path (no KernelZero): writer-side memcpy ------------------
    def writer_copy(self, file: StoreFile, src: np.ndarray) -> Tuple[int, int]:
        """What Arrow IPC without Zerrow does: copy the buffer into the
        shared-memory file (Figure 1, degree C)."""
        arr = np.ascontiguousarray(src).view(np.uint8).reshape(-1)
        n = arr.nbytes
        if n == 0:
            return file.length, 0
        dst = alloc_aligned(n)
        np.copyto(dst, arr)  # the real write-side memcpy Zerrow eliminates
        off = file.append_extent(dst)
        self.store.stats.bytes_copied += n
        return off, n
