"""The port's pure-Python oracles (``repro_torch.core.oracle``) against the
reference's (``repro.core.oracle``).

Seeded random streams of inserts, deletes and searches (foresight and
base searches, keys from a small span so that hits, misses, upserts and
repeated deletes all happen) run through both packages' ``DictOracle``
and ``PySkipList``; every answer, ``sorted_keys``, ``n``, the
``accesses`` counter and ``check_foresight_invariant`` must be equal.
"""
import random

import pytest

from repro.core import oracle as ref
from repro_torch.core import oracle as port


def _stream(seed: int, n_ops: int, span: int):
    rng = random.Random(seed)
    for _ in range(n_ops):
        r = rng.random()
        k = rng.randrange(-span, span)
        if r < 0.4:
            yield ("insert", k, rng.randrange(1 << 20))
        elif r < 0.65:
            yield ("delete", k, None)
        else:
            yield ("search", k, rng.random() < 0.5)   # foresight or base


def _run(mod, seed: int, levels: int, n_ops: int, span: int):
    d, s = mod.DictOracle(), mod.PySkipList(levels=levels, seed=seed)
    out = []
    for op, k, arg in _stream(seed, n_ops, span):
        if op == "insert":
            out.append((d.insert(k, arg), s.insert(k, arg)))
        elif op == "delete":
            out.append((d.delete(k), s.delete(k)))
        else:
            out.append((d.search(k), s.search(k, foresight=arg),
                        s.accesses))
    return out, d.sorted_keys(), s.sorted_keys(), s.n, s.accesses, \
        s.check_foresight_invariant()


@pytest.mark.parametrize("seed,levels,n_ops,span", [
    (0, 20, 2000, 300), (1, 4, 2000, 100), (2, 1, 500, 50),
    (3, 12, 4000, 2000), (4, 20, 3000, 40), (5, 8, 1000, 1 << 30),
])
def test_streams_equal_the_reference(seed, levels, n_ops, span):
    got = _run(port, seed, levels, n_ops, span)
    want = _run(ref, seed, levels, n_ops, span)
    assert got == want
    answers, dict_keys, list_keys, n, accesses, invariant = got
    assert dict_keys == list_keys and n == len(list_keys)
    assert invariant and accesses > 0


def test_the_skiplist_agrees_with_the_dict_oracle():
    answers = _run(port, 7, 16, 3000, 500)[0]
    for a in answers:
        if len(a) == 2:
            assert a[0] == a[1]
        else:
            (found, val), (sfound, sval), _ = a
            assert (found, val) == (sfound, sval)


def test_heights_and_fused_records_equal_the_reference():
    a, b = port.PySkipList(levels=10, seed=11), ref.PySkipList(levels=10,
                                                               seed=11)
    for k in random.Random(11).sample(range(10_000), 800):
        a.insert(k, k + 1)
        b.insert(k, k + 1)

    def towers(s):
        out, x = [], s.head
        while x is not None:
            out.append((x.key, x.val, len(x.nxt), list(x.fkey)))
            x = x.nxt[0]
        return out

    assert towers(a) == towers(b)
    assert a.rng.getstate() == b.rng.getstate()
    assert (port.KEY_MIN, port.KEY_MAX) == (ref.KEY_MIN, ref.KEY_MAX)
