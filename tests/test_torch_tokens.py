"""The port's synthetic LM token pipeline (``repro_torch.data.tokens``)
against the reference's (``repro.data.tokens``): the streams are numpy
in both packages and must be bit-identical for every (seed, node,
step), the stubbed frontend's extras included."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import tokens as j_tokens  # noqa: E402
from repro_torch.data import tokens as t_tokens  # noqa: E402


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


@pytest.mark.parametrize("seed,nodes,q,extras", [
    (0, 8, 1, None),
    (0, 4, 2, None),
    (3, 2, 4, None),
    (7, 3, 1, {"prefix_embeds": (4, 16)}),
    (1, 2, 2, {"prefix_embeds": (2, 8), "frames": (3, 5)}),
])
def test_fl_token_batches_are_the_references(seed, nodes, q, extras):
    want = j_tokens.make_fl_token_batches(512, nodes, 2, 17, q=q, seed=seed, extras=extras)
    got = t_tokens.make_fl_token_batches(512, nodes, 2, 17, q=q, seed=seed, extras=extras)
    for _ in range(3):
        a, b = next(got), next(want)
        assert sorted(a) == sorted(b)
        for key in b:
            assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape
            np.testing.assert_array_equal(a[key], b[key])
    assert a["tokens"].shape == (q, nodes, 2, 18)


@pytest.mark.parametrize("vocab,node,seed,step", list(itertools.product(
    (97, 49152), (0, 5), (0, 11), (0, 3))))
def test_token_stream_is_the_references(vocab, node, seed, step):
    a = t_tokens.TokenStream(vocab, node=node, seed=seed).sample(3, 33, step)
    b = j_tokens.TokenStream(vocab, node=node, seed=seed).sample(3, 33, step)
    assert a.dtype == np.int32
    np.testing.assert_array_equal(a, b)
