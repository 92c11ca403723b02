"""The torch port's ``StreamingSessionPool`` against the JAX package's pool
and the port's own solo session, at the JAX tests' tiny width
(``tests/test_pool.py``): slots that join mid-flight and move at different
rates give the JAX pool's greedy tokens; a sampled slot gives the solo
session's tokens under the same seed; a slot at full context and token
capacity survives other slots' traffic; a freed slot's stale caches are
invisible to its next occupant; ``round`` equals ``feed`` then
``generate``; the guards; and the caches are written in place, never
copied. The JAX pool's ``mesh=`` case is held in ``test_torch_mesh.py``;
its bf16 case runs on the card.
"""

import numpy as np
import pytest
import torch

from dyadic_interaction_modeling_tpu.serving import StreamingSessionPool as JPool
from dyadic_interaction_modeling_tpu_torch.serving import (
    StreamingListenerSession, StreamingSessionPool)
from test_torch_streaming import clip, slmft_pair


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    return slmft_pair(seed=2)


def _solo(tm, sp, au, prompt, seed, schedule, *, greedy, max_frames=16, max_tokens=16):
    """One stream through a solo session following ``schedule``: ("feed",
    lo, hi), ("start",) and ("gen", n) ops."""
    sess = StreamingListenerSession(tm, batch=1, chunk=4, max_frames=max_frames,
                                    max_tokens=max_tokens, seed=seed, greedy=greedy)
    for op in schedule:
        if op[0] == "feed":
            sess.feed(sp[None, op[1]: op[2]], au[None, op[1]: op[2]])
        elif op[0] == "start":
            sess.start(prompt[None])
        else:
            sess.generate(op[1])
    return sess.tokens()[0].numpy()


def _multiplex(pool, vs, va):
    """Two streams that join at different times and move at different rates
    (tests/test_pool.py:43-63)."""
    pa, pb = np.zeros((1, 1), np.int32), np.ones((1, 1), np.int32)
    a = pool.join(seed=5)
    pool.feed([a], vs[0:1, 0:4], va[0:1, 0:4])
    pool.feed([a], vs[0:1, 4:8], va[0:1, 4:8])
    pool.start([a], pa)
    pool.generate([a], 3)
    b = pool.join(seed=9)
    assert b != a
    pool.feed([a, b], np.stack([vs[0, 8:12], vs[1, 0:4]]), np.stack([va[0, 8:12], va[1, 0:4]]))
    pool.start([b], pb)
    pool.generate([b], 2)
    pool.generate([a, b], 4)
    pool.feed([b], vs[1:2, 4:8], va[1:2, 4:8])
    pool.generate([b], 3)
    return a, b


SCHEDULES = ([("feed", 0, 4), ("feed", 4, 8), ("start",), ("gen", 3), ("feed", 8, 12),
              ("gen", 4)],
             [("feed", 0, 4), ("start",), ("gen", 2), ("gen", 4), ("feed", 4, 8), ("gen", 3)])


def test_pool_greedy_slots_match_jax_pool(pair):
    """Each slot's greedy tokens equal the JAX pool's over the same calls,
    and the solo sessions'."""
    jm, params, tm = pair
    vs, _, va = clip(7)
    kw = dict(capacity=3, chunk=4, max_frames=16, max_tokens=16, greedy=True)
    jpool = JPool(jm, {"params": params}, **kw)
    pool = StreamingSessionPool(tm, **kw)
    ja, jb = _multiplex(jpool, vs, va)
    a, b = _multiplex(pool, vs, va)
    assert (a, b) == (ja, jb)
    for slot, prompt, seed, sched, stream in ((a, 0, 5, SCHEDULES[0], 0),
                                              (b, 1, 9, SCHEDULES[1], 1)):
        got = pool.tokens(slot).numpy()
        np.testing.assert_array_equal(got, np.asarray(jpool.tokens(slot)))
        np.testing.assert_array_equal(got, _solo(tm, vs[stream], va[stream],
                                                 np.array([prompt]), seed, sched,
                                                 greedy=True))
    assert pool.frames_fed(a) == 12 and pool.frames_fed(b) == 8
    assert pool.tokens_generated(a) == 8 and pool.tokens_generated(b) == 10
    np.testing.assert_allclose(pool.motion(a).numpy(), np.asarray(jpool.motion(a)),
                               rtol=1e-5, atol=1e-5)


def test_pool_sampled_slots_match_solo_sessions(pair):
    """Sampled at the defaults: each slot draws from its own generator, as a
    solo session seeded alike, whatever the other slot does."""
    tm = pair[2]
    vs, _, va = clip(8)
    pool = StreamingSessionPool(tm, capacity=3, chunk=4, max_frames=16, max_tokens=16)
    caches = [t.data_ptr() for t in (*pool._enc_s.values(), *pool._dec.values(),
                                     *(x for kv in pool._cross for x in kv))]
    a, b = _multiplex(pool, vs, va)
    for slot, prompt, seed, sched, stream in ((a, 0, 5, SCHEDULES[0], 0),
                                              (b, 1, 9, SCHEDULES[1], 1)):
        np.testing.assert_array_equal(
            pool.tokens(slot).numpy(),
            _solo(tm, vs[stream], va[stream], np.array([prompt]), seed, sched, greedy=False))
    # written in place: the caches are the tensors allocated at construction
    assert caches == [t.data_ptr() for t in (*pool._enc_s.values(), *pool._dec.values(),
                                             *(x for kv in pool._cross for x in kv))]


def test_full_slot_survives_other_traffic(pair):
    """A slot at full context and token capacity is untouched by another
    slot's feeds and generates: idle writes land in the slack region."""
    tm = pair[2]
    vs, _, va = clip(9)
    p = np.zeros((1, 1), np.int32)
    pool = StreamingSessionPool(tm, capacity=2, chunk=4, max_frames=8, max_tokens=6,
                                greedy=True)
    a = pool.join(seed=3)
    pool.feed([a], vs[0:1, 0:4], va[0:1, 0:4])
    pool.feed([a], vs[0:1, 4:8], va[0:1, 4:8])
    pool.start([a], p)
    first = pool.generate([a], 2)
    b = pool.join(seed=1)
    pool.feed([b], vs[1:2, 0:4], va[1:2, 0:4])
    pool.start([b], p)
    pool.generate([b], 3)
    pool.feed([b], vs[1:2, 4:8], va[1:2, 4:8])
    pool.generate([b], 2)
    rest = pool.generate([a], 3)
    solo = _solo(tm, vs[0], va[0], p[0], 3, [("feed", 0, 4), ("feed", 4, 8), ("start",),
                                            ("gen", 2), ("gen", 3)],
                 greedy=True, max_frames=8, max_tokens=6)
    np.testing.assert_array_equal(torch.cat([first[0], rest[0]]).numpy(), solo)


def test_slot_reuse_after_leave(pair):
    tm = pair[2]
    vs, _, va = clip(10)
    p = np.zeros((1, 1), np.int32)
    pool = StreamingSessionPool(tm, capacity=1, chunk=4, max_frames=16, max_tokens=16,
                                greedy=True)
    a = pool.join(seed=11)
    pool.feed([a], vs[1:2, 0:4] + 3.0, va[1:2, 0:4] - 2.0)
    pool.start([a], p + 2)
    pool.generate([a], 5)
    pool.leave(a)
    b = pool.join(seed=7)
    assert b == a
    pool.feed([b], vs[0:1, 0:4], va[0:1, 0:4])
    pool.feed([b], vs[0:1, 4:8], va[0:1, 4:8])
    pool.start([b], p)
    pool.generate([b], 6)
    solo = _solo(tm, vs[0], va[0], p[0], 7, [("feed", 0, 4), ("feed", 4, 8), ("start",),
                                            ("gen", 6)], greedy=True)
    np.testing.assert_array_equal(pool.tokens(b).numpy(), solo)


def test_pool_guards(pair):
    tm = pair[2]
    vs, _, va = clip(11)
    pool = StreamingSessionPool(tm, capacity=2, chunk=4, max_frames=8, max_tokens=4,
                                greedy=True)
    a = pool.join()
    with pytest.raises(ValueError, match="not join"):
        pool.feed([a, 1], np.zeros((2, 4, 56)), np.zeros((2, 4, 16)))
    with pytest.raises(ValueError, match="duplicate"):
        pool.feed([a, a], np.zeros((2, 4, 56)), np.zeros((2, 4, 16)))
    with pytest.raises(ValueError, match="feed at least one"):
        pool.start([a], np.zeros((1, 1), np.int32))
    pool.feed([a], vs[0:1, :4], va[0:1, :4])
    with pytest.raises(ValueError, match="before generate"):
        pool.generate([a], 1)
    with pytest.raises(ValueError, match="before round"):
        pool.round([a], vs[0:1, 4:8], va[0:1, 4:8])
    with pytest.raises(ValueError, match="expected"):
        pool.feed([a], vs[0:1, :3], va[0:1, :3])
    pool.feed([a], vs[0:1, 4:8], va[0:1, 4:8])
    with pytest.raises(ValueError, match="context capacity"):
        pool.feed([a], vs[0:1, :4], va[0:1, :4])
    pool.start([a], np.zeros((1, 1), np.int32))
    pool.generate([a], 3)
    with pytest.raises(ValueError, match="token capacity"):
        pool.generate([a], 2)
    with pytest.raises(ValueError, match="empty"):
        pool.generate([], 1)
    b = pool.join()
    assert b != a
    with pytest.raises(RuntimeError, match="pool full"):
        pool.join()
    pool.leave(b)
    assert pool.join() == b and list(pool.active_slots()) == [a, b]


def test_pool_round_equals_feed_then_generate(pair):
    """With an idle slot in the pool and a short (n_valid) chunk."""
    tm = pair[2]
    vs, _, va = clip(12)
    prompts = np.array([[0], [1]], np.int32)

    def run(fused):
        pool = StreamingSessionPool(tm, capacity=3, chunk=4, max_frames=16, max_tokens=20)
        sl = [pool.join(seed=5), pool.join(seed=9)]
        pool.feed(sl, vs[:, :4], va[:, :4])
        pool.start(sl, prompts)
        pool.generate(sl, 4)
        for t, nv in ((4, 4), (8, 4), (12, 2)):
            if fused:
                pool.round(sl, vs[:, t: t + 4], va[:, t: t + 4], n=3, n_valid=nv)
            else:
                pool.feed(sl, vs[:, t: t + 4], va[:, t: t + 4], n_valid=nv)
                pool.generate(sl, 3)
        assert pool.frames_fed(sl[0]) == 14
        return torch.stack([pool.tokens(s) for s in sl])

    assert torch.equal(run(True), run(False))
