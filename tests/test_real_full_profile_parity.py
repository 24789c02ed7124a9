"""Live byte-parity at the REAL full profile constants:
HTSIZE=1,610,612,741, k=31 — /root/reference/src/parameters.hh:39 with u32
on-disk quotients selected at this width (main.cc:251-286).

The .sz file is one byte per hash bucket = 1.6 GB, so both engines write
multi-GB artifacts and the reference's in-RAM table is ~26 GB
(hashTable_hh.hh:183 m_table.resize(HTSIZE), 16 B/bucket): this test is
gated behind CLARK_TPU_FULL_PARITY=1 (run it explicitly; a green run is
recorded in docs/PARITY.md).  The .sz compare is streamed.
"""

import os
import subprocess

import numpy as np
import pytest

from jn_cuclark_tpu.db import builder
from jn_cuclark_tpu.engine import Classifier
from jn_cuclark_tpu.io.targets import parse_targets
from jn_cuclark_tpu.params import FULL, FULL_HTSIZE

HERE = os.path.dirname(os.path.abspath(__file__))
TOOLS = os.path.join(HERE, "tools")

import sys  # noqa: E402

sys.path.insert(0, TOOLS)
import refbuild  # noqa: E402

pytestmark = [
    pytest.mark.skipif(
        not refbuild.available(), reason="reference tree or g++ absent"
    ),
    pytest.mark.skipif(
        os.environ.get("CLARK_TPU_FULL_PARITY") != "1",
        reason="1.6 GB .sz / ~26 GB reference RAM; set "
               "CLARK_TPU_FULL_PARITY=1 to run",
    ),
]

K = 31


def _files_equal_streamed(pa, pb, chunk=1 << 26):
    if os.path.getsize(pa) != os.path.getsize(pb):
        return False
    with open(pa, "rb") as fa, open(pb, "rb") as fb:
        while True:
            a = fa.read(chunk)
            b = fb.read(chunk)
            if a != b:
                return False
            if not a:
                return True


def test_real_full_profile_parity(tmp_path):
    assert FULL.htsize == FULL_HTSIZE == 1_610_612_741
    assert FULL.key_dtype(K) == np.uint32  # the real full-profile width
    rng = np.random.default_rng(1610)

    def rs(n):
        return "".join(rng.choice(list("ACGT"), n))

    genomes = [rs(4000), rs(3500)]
    shared = rs(300)  # RemoveCommon must fire at these constants too
    genomes[0] += shared
    genomes[1] += shared
    with open(tmp_path / "targets.txt", "w") as tf:
        for i, g in enumerate(genomes):
            p = tmp_path / f"g{i}.fa"
            with open(p, "w") as f:
                f.write(f">g{i}\n")
                for j in range(0, len(g), 70):
                    f.write(g[j : j + 70] + "\n")
            tf.write(f"{p} {3001 + i}\n")
    with open(tmp_path / "reads.fa", "w") as f:
        for i in range(150):
            g = genomes[i % 2]
            ln = int(rng.integers(80, 200))
            pos = int(rng.integers(0, len(g) - ln))
            f.write(f">r{i}\n{g[pos:pos+ln]}\n")
        f.write(f">junk\n{rs(120)}\n")

    exe = refbuild.stage_engine(FULL_HTSIZE, False, "/tmp/ref_full_real")
    dbref = tmp_path / "dbref"
    dbref.mkdir()
    refbuild.run_engine(
        exe,
        str(tmp_path / "targets.txt"),
        str(dbref),
        str(tmp_path / "reads.fa"),
        str(tmp_path / "ref_out"),
        K,
    )

    targets = parse_targets(str(tmp_path / "targets.txt"))
    ours = tmp_path / "db"
    ours.mkdir()
    builder.build_database(targets, str(ours), FULL, K)
    stem = FULL.db_stem(K, targets.n_targets, 0, FULL.default_gap)
    for ext in (".sz", ".ky", ".lb"):
        assert _files_equal_streamed(
            str(dbref / (stem + ext)), str(ours / (stem + ext))
        ), f"{ext} differs at real full HTSIZE"

    clf = Classifier.load(str(ours), targets, FULL, K)
    clf.classify_file(str(tmp_path / "reads.fa"), str(tmp_path / "our_out"))
    assert (tmp_path / "our_out.csv").read_bytes() == (
        tmp_path / "ref_out.csv"
    ).read_bytes()
