"""Seeded host-sync defects: blocking device reads on the hot path."""

import threading

import numpy as np
import torch


class WindowVerifier:
    """Entry-pattern class: *Verifier + ENTRY_METHODS seed the graph."""

    def __init__(self):
        self._staging_lock = threading.Lock()
        self._buf = np.zeros((64, 65), np.uint8)
        self.debug_timing = False

    def ecrecover(self, sigs, hashes):
        # holding a lock across the device round trip serializes every
        # submitter — fires even though ecrecover is a resolve boundary
        with self._staging_lock:
            ds = torch.from_numpy(self._buf).to(self.device)
            ok = self._compute(ds)
            torch.cuda.synchronize()         # firing: sync under lock
            out = ok.cpu()                   # firing: D2H under lock
        return out

    def stage_window(self, sigs):  # hot-path-entry
        ds = torch.from_numpy(sigs).to(self.device)
        ok = self._compute(ds)
        n = ok.sum().item()                  # firing: mid-pipeline sync
        return ok[:n]

    def _compute(self, ds):
        return ds

    def stage_probe(self, sigs):  # hot-path-entry
        ok = self._compute(torch.from_numpy(sigs))
        return ok.tolist()  # analysis: allow-host-sync(fixture: a probe)


def bucket_round(n, minimum):
    b = max(n, minimum)
    return 1 << (b - 1).bit_length()


class CleanVerifier:
    """The approved shapes: gate, boundary, collect — all quiet."""

    def __init__(self):
        self.debug_timing = False

    def verify(self, sigs, hashes, pubs):
        b = bucket_round(len(sigs), 16)
        padded = sigs[:b]
        ds = torch.from_numpy(padded)
        if self.debug_timing:
            torch.cuda.synchronize()         # clean: debug-gated probe
        ok = ds
        torch.cuda.synchronize()             # clean: sync facade boundary
        return ok.cpu().numpy()              # clean: boundary D2H

    def collect_recover(self, st):
        torch.cuda.synchronize()             # clean: collect half
        return st.cpu().numpy()
