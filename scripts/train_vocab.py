"""Train the packaged binary vocabulary from rendered-scene ORB descriptors.

The reference ships a 1M-word ORBvoc trained offline on real imagery
(absent from its snapshot; loaded via TemplatedVocabulary::loadFromTextFile).
This framework's packaged vocabulary (orbslam3_jax/data/vocab_synth.npz) is
trained here: bit_pattern_31 ORB descriptors extracted from many rendered
viewpoints across several scene seeds, hierarchical k-medians (k=10, L=4 →
10k words), tf-idf weights from a corpus pass (reference
TemplatedVocabulary.h:135-162). Run: python scripts/train_vocab.py
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(out_path=None, levels=4, n_scenes=6, imgs_per_scene=20):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from orbslam3_jax.ops import features as feat_ops
    from orbslam3_jax.utils.datasets import RoomScene

    out_path = out_path or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "orbslam3_jax", "data", "vocab_synth.npz")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)

    cfg = feat_ops.OrbConfig(n_features=512)
    h, w = 240, 376
    extract = feat_ops.make_extractor(h, w, cfg)
    rng = np.random.default_rng(0)
    all_desc, per_image_words_src = [], []
    t0 = time.time()
    for seed in range(n_scenes):
        scene = RoomScene(seed=seed, h=h, w=w, fx=229.3, fy=228.6,
                          cx=188.0, cy=120.0, n_clutter=5)
        for i in range(imgs_per_scene):
            c = np.array([rng.uniform(-2.5, 2.5), rng.uniform(-1.2, 1.2),
                          rng.uniform(0.5, 4.0)])
            yaw = rng.uniform(-0.6, 0.6)
            cy_, sy = np.cos(yaw), np.sin(yaw)
            R_wc = np.array([[cy_, 0, sy], [0, 1, 0], [-sy, 0, cy_]])
            R = R_wc.T
            img = scene.render(R, -R @ c)
            # exposure/blur jitter: a descriptor corpus from clean renders
            # under-represents the intensity-noise modes real imagery has
            img = img * rng.uniform(0.7, 1.3) + rng.normal(0, 3.0, img.shape)
            f = extract(jnp.asarray(img.astype(np.float32)))
            valid = np.asarray(f.valid)
            all_desc.append(np.asarray(f.desc)[valid])
        print(f"scene {seed}: {sum(len(d) for d in all_desc)} descriptors "
              f"({time.time()-t0:.0f}s)", flush=True)
    desc = np.concatenate(all_desc)
    print("training on", len(desc), "descriptors")

    from orbslam3_jax.ops.vocab import BinaryVocabulary
    vocab = BinaryVocabulary(k=10, levels=levels).train(desc, seed=1)
    print(f"trained {vocab.n_words} words ({time.time()-t0:.0f}s)")

    # corpus pass for idf
    tf = vocab.transform_fn()
    word_arrays = []
    i0 = 0
    for d in all_desc:
        wds = np.asarray(tf(jnp.asarray(d), jnp.ones(len(d), bool)))
        word_arrays.append(wds)
    vocab.compute_idf(word_arrays)
    used = (vocab.idf < np.log(len(word_arrays))).sum()
    print(f"idf: {used}/{vocab.n_words} words seen in corpus")
    vocab.save(out_path)
    print("saved", out_path)


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default=None)
    ap.add_argument("--levels", type=int, default=4,
                    help="tree depth (k=10): 4 -> 10k words, 5 -> 100k")
    ap.add_argument("--scenes", type=int, default=6)
    ap.add_argument("--images", type=int, default=20,
                    help="images per scene (100k words wants >=40 scenes x 30)")
    a = ap.parse_args()
    main(a.out, levels=a.levels, n_scenes=a.scenes, imgs_per_scene=a.images)
