"""The ``search_state`` driver: the ``search`` driver's agent tree search
on a model with recurrent sublayers, whose check also reads back the
recurrent state.

Everything of the set-up, the window and the sample of nodes is the
``search`` driver's (``bench/drivers/search.py``).  Where that driver
reads a session's keys and values back for the check (the trunk, and
each sampled node restored fast or slow), this one also copies the
session's recurrent states (``PagePool.state_keys``: per sublayer its
leaves, ``(N_periods, ...)``) to the host.  The ``search`` driver reads
a slow-sampled node twice, a fast fork of its template just before the
template's eviction and then the slow restore, and counts in
``slow_not_bit_equal`` the nodes whose two reads differ in K or V (or in
shape, a restore that came back by another path).  This driver adds to
that count the nodes whose K and V agree but whose states differ in a
bit of any leaf, and fails a run that compared no such pair
(``no_slow_pair_compared``).  The reference holds the states to its own
(``state_rel_err``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from bench.drivers.search import SearchDriver


class SearchStateDriver(SearchDriver):
    def _kv(self, sess, lo: int) -> Dict[str, Any]:
        """The ``search`` driver's K/V of positions [lo, seq_len), with the
        session's recurrent states as ``state``: {sublayer tag: {leaf: host
        tensor (N_periods, ...)}}.  The first read after a template's
        eviction is that node's slow restore: its states are compared with
        those of the read just before the eviction, the twin."""
        out = super()._kv(sess, lo)
        out["state"] = {key.split("/", 1)[1]: {leaf: t[:, 0].cpu() for leaf, t in
                                               sess.extras[key].items()}
                        for key in sorted(self.pool.state_keys)}
        twin, self._twin = self._twin, None
        if twin is not None:
            self._pairs += 1
            self._state_only += _kv_equal(twin, out) and not _same(twin, out)
        self._last = out
        return out

    def collect(self) -> None:
        self._twin = self._last = None
        self._pairs = self._state_only = 0
        cr = self.cr
        evict = cr.evict_template

        def evict_after_twin(ckpt: int) -> bool:
            self._twin = self._last                 # the fast fork read just before
            return evict(ckpt)

        cr.evict_template = evict_after_twin
        try:
            super().collect()
        finally:
            del cr.evict_template
        out = self.outputs
        out["slow_not_bit_equal"] += self._state_only
        out["slow_pairs_compared"] = self._pairs
        self._twin = self._last = None
        out["trunk_state"] = out["trunk"].pop("state")
        for n in out["nodes"]:
            if n.get("kv") is not None:
                n["state"] = n["kv"].pop("state")

    def check(self, reference, control: bool) -> Dict[str, Any]:
        pairs = self.outputs["slow_pairs_compared"]
        verdict = super().check(reference, control)
        verdict["checks"]["no_slow_pair_compared"] = {"value": int(pairs == 0), "limit": 0}
        verdict["info"]["slow_pairs_compared"] = pairs
        return verdict


def _kv_equal(a: Dict[str, Any], b: Dict[str, Any]) -> bool:
    return torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])


def _same(a: Dict[str, Any], b: Dict[str, Any]) -> bool:
    """Two reads equal bit for bit in K, V and every state leaf."""
    if not _kv_equal(a, b):
        return False
    return all(torch.equal(a["state"][tag][leaf], b["state"][tag][leaf])
               for tag in a["state"] for leaf in a["state"][tag])


Driver = SearchStateDriver
