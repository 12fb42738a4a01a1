"""DBoW2 text-vocabulary loader (reference TemplatedVocabulary::
loadFromTextFile, Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h:241)."""
import numpy as np
import jax.numpy as jnp

from orbslam3_jax.ops import vocab as vocab_ops


def _desc_line(parent, leaf, desc_bytes, weight):
    return (f"{parent} {int(leaf)} " + " ".join(str(int(b)) for b in desc_bytes)
            + f" {weight}")


def test_load_dbow2_text_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    # k=2, L=2 tree: root → n1, n2 (interior); n1 → w0, w1; n2 → w2, w3
    d = rng.integers(0, 256, (6, 32), dtype=np.uint8)
    # make the two subtrees clearly separated: n1/children low bits, n2 high
    d[0][:] = 0x00     # n1
    d[1][:] = 0xFF     # n2
    d[2][:] = 0x00; d[2][0] = 0x01        # w0 (near n1)
    d[3][:] = 0x00; d[3][0] = 0x0F        # w1
    d[4][:] = 0xFF; d[4][0] = 0xFE        # w2 (near n2)
    d[5][:] = 0xFF; d[5][0] = 0xF0        # w3
    lines = ["2 2 0 0",
             _desc_line(0, 0, d[0], 0.0),
             _desc_line(0, 0, d[1], 0.0),
             _desc_line(1, 1, d[2], 0.4),
             _desc_line(1, 1, d[3], 0.3),
             _desc_line(2, 1, d[4], 0.2),
             _desc_line(2, 1, d[5], 0.1)]
    p = tmp_path / "voc.txt"
    p.write_text("\n".join(lines) + "\n")

    voc = vocab_ops.load_dbow2_text(str(p))
    assert voc.n_words == 4
    assert voc.levels == 2
    np.testing.assert_allclose(voc.word_weight, [0.4, 0.3, 0.2, 0.1])

    transform = voc.transform_fn()
    # query with the leaf descriptors themselves → their own word ids
    queries = d[2:6].copy().view(np.uint32).reshape(4, 8)
    words = np.asarray(transform(jnp.asarray(queries), jnp.ones(4, bool)))
    np.testing.assert_array_equal(words, [0, 1, 2, 3])

    # BoW vector: tf·weight, L1-normalized
    bow = voc.bow_fn()
    v = np.asarray(bow(jnp.asarray(words)))
    expect = np.asarray([0.4, 0.3, 0.2, 0.1])
    np.testing.assert_allclose(v, expect / expect.sum(), rtol=1e-5)


def test_loaded_vocab_scores_match_trained_api(tmp_path):
    """A loaded vocabulary is a drop-in for the trained one in the closer."""
    rng = np.random.default_rng(1)
    d = rng.integers(0, 256, (2 + 4, 32), dtype=np.uint8)
    lines = ["2 2 0 0",
             _desc_line(0, 0, d[0], 0.0), _desc_line(0, 0, d[1], 0.0),
             _desc_line(1, 1, d[2], 1.0), _desc_line(1, 1, d[3], 1.0),
             _desc_line(2, 1, d[4], 1.0), _desc_line(2, 1, d[5], 1.0)]
    p = tmp_path / "voc.txt"
    p.write_text("\n".join(lines) + "\n")
    voc = vocab_ops.load_dbow2_text(str(p))
    transform = voc.transform_fn()
    bow = voc.bow_fn()
    q = rng.integers(0, 2 ** 32, (32, 8), dtype=np.uint32)
    words = transform(jnp.asarray(q), jnp.ones(32, bool))
    v = bow(words)
    s = vocab_ops.l1_scores(v, v[None, :])
    assert abs(float(s[0]) - 2.0) < 1e-5  # self-similarity = 2·Σmin(v,v) = 2
