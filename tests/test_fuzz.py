"""Corrupt-stream differential conformance (a small always-on slice of
the crosscheck --fuzz campaign, whose full runs are 500+ trials).

Mutated data packets (truncations, bit flips, zeroed ranges, random
tails) must produce the SAME per-packet accept/dup/reject decision and
byte-identical output frames in our decoder and the reference,
including recovery after rejected packets (zeros-past-EOF and
dummy-frame semantics, bitpack.c:47-53 / decode.c:2053-2082)."""
import os

import numpy as np
import pytest

from tests.conftest import REPO_ROOT, ensure_ref_oracle


def test_fuzzed_packets_match_reference(tmp_path):
    if not ensure_ref_oracle():
        pytest.skip("reference oracle unavailable")
    if not os.path.exists(
        os.path.join(REPO_ROOT, "refbuild", "build", "ref_fuzz")
    ):
        import subprocess

        subprocess.run(
            ["make", "-C", os.path.join(REPO_ROOT, "refbuild"),
             "build/ref_fuzz"],
            check=True, capture_output=True,
        )
    from theora_tpu.tools.crosscheck import run_fuzz_trial

    rng = np.random.RandomState(77)
    fails = []
    for t in range(8):
        desc, err = run_fuzz_trial(
            rng, t, tmp=str(tmp_path / f"fz{t}")
        )
        if err:
            fails.append((desc, err))
    assert not fails, fails


def test_synthetic_random_plans_match_reference():
    """Legal-but-RD-atypical streams (random coding plans through
    pack_frame_plan: arbitrary mode/MV/qi-triple/qii/coefficient
    combinations no RD-driven encoder emits) decode identically in
    both decoders -- the legal-stream-space direction of the
    conformance campaign."""
    if not ensure_ref_oracle():
        pytest.skip("reference oracle unavailable")
    from theora_tpu.tools.crosscheck import run_synth_trial

    rng = np.random.RandomState(55)
    fails = []
    for t in range(6):
        desc, err = run_synth_trial(rng, t)
        if err:
            fails.append((desc, err))
    assert not fails, fails


def test_mutated_headers_match_reference(tmp_path):
    """Header-packet differential slice (crosscheck --hdr): mutated
    info/comment/setup packets (hostile field values, bit damage,
    sequence damage) must yield the IDENTICAL th_decode_headerin return
    code sequence, the identical alloc decision, and byte-identical
    decoded output vs the reference (decinfo.c:182-272,
    dequant.c:24-144, huffdec.c:193-240); full crosscheck --hdr runs
    are 300+ trials."""
    if not ensure_ref_oracle():
        pytest.skip("reference oracle unavailable")
    import subprocess

    hdr_bin = os.path.join(REPO_ROOT, "refbuild", "build", "ref_hdr")
    if not os.path.exists(hdr_bin):
        subprocess.run(
            ["make", "-C", os.path.join(REPO_ROOT, "refbuild"),
             "build/ref_hdr"],
            check=True, capture_output=True,
        )
    from theora_tpu.tools.crosscheck import run_hdr_fuzz_trial

    rng = np.random.RandomState(31)
    fails = []
    for t in range(10):
        desc, err = run_hdr_fuzz_trial(
            rng, t, tmp=str(tmp_path / f"hd{t}")
        )
        if err:
            fails.append((desc, err))
    assert not fails, fails
