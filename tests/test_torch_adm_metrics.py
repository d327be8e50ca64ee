"""The port's ADM evaluator (``fluidnexus_torch/utils/adm_metrics.py``, the
``evaluate_adm`` stage) against the JAX package's on the CPU.

Tolerances: features (the weight-free ``default_feature_fn`` and VGG16's
``vgg_feature_fn``) within 1e-5 of max|ref|; the squared distances within
1e-6 relative; FID, sFID and IS from the same features bit for bit (the
same float64 numpy and scipy on the host), from each package's own features
within 1e-5 relative. Precision and recall test f32 squared distances with
``<=`` against radii, where XLA's CPU product and torch's can round a
borderline pair to the other side: their inputs are asserted to keep every
distance more than 1e-4 relative from every radius, and then P and R must be
equal.
"""
import numpy as np
import pytest
import torch
import yaml

from fluidnexus_torch.utils import adm_metrics as tam
from fluidnexus_torch.utils import perceptual as tper
from fluidnexus_tpu.utils import adm_metrics as jam

FEATURE_TOL = 1e-5
DIST_TOL = 1e-6
METRIC_TOL = 1e-5
MARGIN = 1e-4


def held(got, ref, tol, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"{what}: max|err| {err:.3e} > {tol} x {scale:.3e}"


def images(n, h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)


def assert_margin(ref, sample, k=3):
    """No squared distance of the P/R tests within MARGIN relative of a
    radius (float64 distances, the radii as either package gives them)."""
    ref, sample = np.asarray(ref, np.float64), np.asarray(sample, np.float64)

    def sq(a, b):
        return ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)

    r_ref = np.sort(sq(ref, ref), 1)[:, k]
    r_smp = np.sort(sq(sample, sample), 1)[:, k]
    d = sq(ref, sample)
    for dist, radii in ((d, r_smp[None, :]), (d, r_ref[:, None])):
        gap = np.abs(dist - radii) / np.maximum(radii, 1e-30)
        assert gap.min() > MARGIN, f"a distance within {gap.min():.2e} of a radius"


@pytest.mark.parametrize("shape", [(12, 32, 32), (7, 20, 28)])
def test_default_feature_fn(shape):
    x = images(*shape, seed=shape[1])
    got, ref = tam.default_feature_fn(x, device="cpu"), jam.default_feature_fn(x)
    for g, r, what in zip(got, ref, ("pool", "spatial")):
        held(g, r, FEATURE_TOL, what)


def test_vgg_feature_fn_as_the_jax_package_reads_its_input():
    """The JAX ``vgg_feature_fn`` runs its images as (N, C, H, W): the port
    does the same (4 images, 3 x 32 x 32)."""
    params = tper.random_params(0)
    x = images(4, 32, 32, seed=1).transpose(0, 3, 1, 2)
    got = tam.vgg_feature_fn(params, batch=3, device="cpu")(x)
    ref = jam.vgg_feature_fn(params, batch=3)(x)
    for g, r, what in zip(got, ref, ("pool", "spatial")):
        held(g, r, FEATURE_TOL, what)
    assert got[0].shape == (4, 2) and got[1].shape == (4, 256 * 8 * 7)


def test_vgg_feature_fn_refuses_nhwc_images_in_both():
    """The reference's npz holds (N, H, W, 3) uint8 images, which
    ``evaluate_npz`` hands to the feature function as they are: with
    ``--vgg16`` both packages' networks read H as the channels and raise."""
    x = images(2, 32, 32, seed=2)
    with pytest.raises(RuntimeError):
        tam.vgg_feature_fn(device="cpu")(x)
    with pytest.raises(ValueError):
        jam.vgg_feature_fn()(x)


def test_pairwise_sq_distances():
    rng = np.random.default_rng(3)
    u = rng.normal(size=(70, 24)).astype(np.float32)
    v = (rng.normal(size=(50, 24)) + 0.3).astype(np.float32)
    got = tam.pairwise_sq_distances(u, v, "cpu").numpy()
    ref = np.asarray(jam.pairwise_sq_distances(u, v))
    np.testing.assert_allclose(got, ref, rtol=DIST_TOL, atol=0)
    exact = ((u[:, None].astype(np.float64) - v[None]) ** 2).sum(-1)
    held(got, exact, 1e-5, "against float64")


def pr_features(seed=4):
    rng = np.random.default_rng(seed)
    ref = rng.normal(size=(90, 6)).astype(np.float32)
    smp = (rng.normal(size=(70, 6)) * 1.3 + 0.4).astype(np.float32)
    return ref, smp


def test_radii_and_precision_recall():
    ref, smp = pr_features()
    assert_margin(ref, smp)
    for feats in (ref, smp):
        got = tam.manifold_radii(feats, row_batch_size=17, col_batch_size=23, device="cpu")
        want = jam.manifold_radii(feats, row_batch_size=17, col_batch_size=23)
        np.testing.assert_allclose(got, want, rtol=DIST_TOL, atol=0)
    got = tam.precision_recall(ref, smp, row_batch_size=17, col_batch_size=23, device="cpu")
    want = jam.precision_recall(ref, smp, row_batch_size=17, col_batch_size=23)
    assert got == want
    assert 0 < got[0] < 1 and 0 < got[1] < 1


def test_radii_rank_counts_the_point_itself():
    """nhood 1 is the nearest other point: rank 0 is the point itself."""
    x = np.array([[0.0], [1.0], [3.0], [7.0]], np.float32)
    got = tam.manifold_radii(x, nhood_sizes=(1, 2), device="cpu")
    np.testing.assert_array_equal(got, [[1, 9], [1, 4], [4, 9], [16, 36]])
    np.testing.assert_array_equal(got, jam.manifold_radii(x, nhood_sizes=(1, 2)))


def test_metrics_from_the_same_features_bit_for_bit():
    ref, smp = pr_features(5)
    assert_margin(ref, smp)
    rng = np.random.default_rng(6)
    ref_s, smp_s = rng.normal(size=(90, 9)), rng.normal(size=(70, 9)) * 0.8
    probs = rng.dirichlet(np.ones(10), size=70)
    got = tam.evaluate_activations(ref, smp, ref_s, smp_s, probs, device="cpu")
    want = jam.evaluate_activations(ref, smp, ref_s, smp_s, probs)
    assert got == want and set(got) == {"IS", "FID", "sFID", "Precision", "Recall"}
    a, b = tam.compute_statistics(ref), jam.compute_statistics(ref)
    assert np.array_equal(a.mu, b.mu) and np.array_equal(a.sigma, b.sigma)
    assert tam.inception_score(probs, 30) == jam.inception_score(probs, 30)


def test_frechet_fallback_and_guard_as_jax():
    """The eps-offset fallback on a singular product, and the
    imaginary-part guard, as JAX's."""
    s1 = tam.ADMStatistics(np.zeros(3), np.diag([1.0, 0.0, 0.0]))
    s2 = tam.ADMStatistics(np.ones(3), np.diag([0.0, 2.0, 0.0]))
    j1 = jam.ADMStatistics(np.zeros(3), np.diag([1.0, 0.0, 0.0]))
    j2 = jam.ADMStatistics(np.ones(3), np.diag([0.0, 2.0, 0.0]))
    assert s1.frechet_distance(s2) == j1.frechet_distance(j2)


def test_softmax_probs():
    rng = np.random.default_rng(7)
    acts, w = rng.normal(size=(37, 16)), rng.normal(size=(16, 10))
    got = tam.softmax_probs(acts, w, batch_size=8, device="cpu")
    held(got, np.asarray(jam.softmax_probs(acts, w, batch_size=8)), FEATURE_TOL, "probs")
    np.testing.assert_allclose(got.sum(1), 1, rtol=1e-6)


def write_batches(tmp_path, n=48, size=24):
    """A reference batch and a blurred, shifted copy as the sample batch."""
    ref = images(n, size, size, seed=8)
    smp = np.clip(0.5 * ref.astype(np.float32) + 0.5 * np.roll(ref, 1, axis=2) + 12,
                  0, 255).astype(np.uint8)
    np.savez(tmp_path / "ref.npz", arr_0=ref)
    (tmp_path / "samples").mkdir()
    np.savez(tmp_path / "samples" / "smp.npz", arr_0=smp)
    return ref, smp


def test_evaluate_npz_both_forms_of_the_reference(tmp_path):
    ref, smp = write_batches(tmp_path)
    assert_margin(tam.default_feature_fn(ref, device="cpu")[0],
                  tam.default_feature_fn(smp, device="cpu")[0])
    smp_p, ref_p = str(tmp_path / "samples" / "smp.npz"), str(tmp_path / "ref.npz")
    got = tam.evaluate_npz(ref_p, smp_p, device="cpu")
    with open(tmp_path / "samples" / "evaluation_metrics.yaml") as f:
        assert yaml.safe_load(f) == got
    want = jam.evaluate_npz(ref_p, smp_p, write_results=False)
    assert set(got) == set(want) == {"FID", "sFID", "Precision", "Recall"}
    for k in ("FID", "sFID"):
        assert got[k] == pytest.approx(want[k], rel=METRIC_TOL) and got[k] > 0
    assert (got["Precision"], got["Recall"]) == (want["Precision"], want["Recall"])
    # the precomputed-statistics form, with and without the images beside them
    pool, spatial = tam.default_feature_fn(ref, device="cpu")
    rs, rss = tam.compute_statistics(pool), tam.compute_statistics(spatial)
    stats = dict(mu=rs.mu, sigma=rs.sigma, mu_s=rss.mu, sigma_s=rss.sigma)
    for with_images in (False, True):
        np.savez(ref_p, **stats, **({"arr_0": ref} if with_images else {}))
        got_s = tam.evaluate_npz(ref_p, smp_p, write_results=False, device="cpu")
        want_s = jam.evaluate_npz(ref_p, smp_p, write_results=False)
        assert set(got_s) == set(want_s)
        assert ("Precision" in got_s) == with_images
        for k in ("FID", "sFID"):
            assert got_s[k] == pytest.approx(got[k], rel=1e-9)
            assert got_s[k] == pytest.approx(want_s[k], rel=METRIC_TOL)


def test_evaluate_adm_through_the_runner(tmp_path, monkeypatch, capsys):
    """``python -m fluidnexus_torch evaluate_adm`` (the runner's device is
    the card; here ``resolve_device`` is patched to the CPU) prints and
    writes what ``evaluate_npz`` gives."""
    from fluidnexus_torch.__main__ import main as runner

    write_batches(tmp_path)
    argv = ["--ref_batch", str(tmp_path / "ref.npz"),
            "--sample_batch", str(tmp_path / "samples" / "smp.npz")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            runner(["evaluate_adm"] + argv)
    monkeypatch.setattr(tam, "resolve_device", lambda d: torch.device("cpu"))
    runner(["evaluate_adm"] + argv)
    printed = dict(line.split(": ") for line in capsys.readouterr().out.strip().splitlines())
    want = tam.evaluate_npz(argv[1], argv[3], write_results=False, device="cpu")
    assert {k: float(v) for k, v in printed.items()} == want
    with open(tmp_path / "samples" / "evaluation_metrics.yaml") as f:
        assert yaml.safe_load(f) == want


def test_evaluate_adm_vgg16_from_a_torchvision_state_dict(tmp_path, monkeypatch):
    """``--vgg16`` loads a torchvision-layout VGG16 state dict (every
    ``features.*`` and ``classifier.*`` key): on the reference's NHWC npz
    both packages raise (the network reads H as channels)."""
    sd = {k: torch.as_tensor(v) for k, v in tper.random_params(1).items()}
    sd["classifier.0.weight"] = torch.zeros(8, 8)
    sd["classifier.0.bias"] = torch.zeros(8)
    torch.save(sd, tmp_path / "vgg16.pth")
    loaded = tper.load_torch_vgg16(str(tmp_path / "vgg16.pth"))
    assert sorted(loaded) == sorted(tper.random_params(1))
    write_batches(tmp_path, n=6, size=32)
    monkeypatch.setattr(tam, "resolve_device", lambda d: torch.device("cpu"))
    argv = ["--ref_batch", str(tmp_path / "ref.npz"),
            "--sample_batch", str(tmp_path / "samples" / "smp.npz"),
            "--vgg16", str(tmp_path / "vgg16.pth")]
    with pytest.raises(RuntimeError):
        tam.main(argv)
    with pytest.raises(ValueError):
        jam.main(argv)
