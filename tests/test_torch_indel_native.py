"""The port's indel realignment (genotype/indel.py::call_indels_realign:
one threaded native call, native/panmap_native.cpp::pt_indel_sites, then
_site_record per site) against the JAX package's per-site walk
(panmap_tpu/genotype/indel.py::call_indels_realign): the same SiteRecords,
field by field, and, site by site, the same glfgen entries handed to the
errmod, on long reads with their true cigars, short-read tiles with planted
multi-allelic indels and the walk's edge cases; the same output at any
thread count; and a raise, naming that oracle, without the library."""

import dataclasses

import numpy as np
import pytest

import panmap_tpu.genotype.indel as jax_indel
import panmap_tpu_torch.native as native
from panmap_tpu_torch.genotype import caller, indel
from panmap_tpu_torch.genotype.indel import IndelInput

BASES = "ACGT"

pytestmark = pytest.mark.skipif(native.get_lib() is None,
                                reason="the native library did not build")


class _Recorder:
    """The caller's errmod, recording each site's entries."""

    def __init__(self):
        self.calls = []

    def cal_arrays(self, eq, es, eb):
        self.calls.append((eq.tolist(), es.tolist(), eb.tolist()))
        return caller._ERRMOD.cal_arrays(eq, es, eb)


def _fields(records):
    return [dataclasses.asdict(r) for r in records]


def _both(ref, inp, threads=4):
    """(records, entries) of the port's native call and of the JAX
    package's walk, which gets a JAX IndelInput of the same arrays and the
    same recording errmod."""
    depth = np.arange(len(ref)) % 97
    nat = _Recorder()
    got = indel.call_indels_realign(ref, inp, depth, nat, threads)
    ref_rec = _Recorder()
    jinp = jax_indel.IndelInput(**{f.name: getattr(inp, f.name)
                                   for f in dataclasses.fields(inp)})
    want = jax_indel.call_indels_realign(ref, jinp, depth, ref_rec)
    return (got, nat.calls), (want, ref_rec.calls)


def _add(ops, op, ln):
    if ops and ops[-1][0] == op:
        ops[-1][1] += ln
    else:
        ops.append([op, ln])


def _pack(reads, rng, mapq=None):
    """IndelInput of [(rs, [[op, len]], seq[, qual])]: Q10-Q20 where a read
    gives no qual of its own."""
    ops, lns, opoff, seqs, quals = [], [], [0], [], []
    for rs, cig, seq, *qual in reads:
        ops += [o for o, _ in cig]
        lns += [ln for _, ln in cig]
        opoff.append(len(ops))
        seqs.append(seq)
        quals.append(np.full(len(seq), qual[0]) if qual
                     else rng.integers(10, 21, len(seq)))
    nk = len(reads)
    return IndelInput(
        rs=np.array([r[0] for r in reads], np.int64),
        ops=np.array(ops, np.int64), lns=np.array(lns, np.int64),
        opoff=np.array(opoff, np.int64),
        seq=np.frombuffer("".join(seqs).encode(), np.uint8).copy(),
        quals=np.concatenate([np.zeros(0)] + quals).astype(np.int64),
        soff=np.concatenate(([0], np.cumsum([len(s) for s in seqs])))
        .astype(np.int64),
        mapq=(rng.integers(0, 61, nk) if mapq is None
              else np.full(nk, mapq)).astype(np.int64),
        rev=rng.integers(0, 2, nk).astype(np.int8))


def _long_read(rng, ref, start, length, planted, err=0.02, snps=None):
    """A read of ~length bases from ref[start:] through the planted events
    ({anchor: +ins seq | -del len}) and SNPs ({pos: base}) at err
    (40/30/30 substitution / deletion / insertion), with its true cigar."""
    cig, seq = [], []
    p = start
    while len(seq) < length and p < len(ref):
        u = rng.random()
        if cig and u < err * 0.3:  # deletion of base p
            _add(cig, 2, 1)
            p += 1
            continue
        b = (snps or {}).get(p, ref[p])
        if u < err * 0.7 and u >= err * 0.3:
            b = BASES[(BASES.index(b) + int(rng.integers(1, 4))) % 4]
        _add(cig, 0, 1)
        seq.append(b)
        ev = planted.get(p)
        if isinstance(ev, str):
            _add(cig, 1, len(ev))
            seq.append(ev)
        elif ev:
            _add(cig, 2, -ev)
            p -= ev
        if err * 0.7 <= u < err:  # insertion after p
            _add(cig, 1, 1)
            seq.append(BASES[int(rng.integers(0, 4))])
        p += 1
    while cig[-1][0] != 0:
        op, ln = cig.pop()
        if op == 1:
            del seq[-ln:]
    return start, cig, "".join(seq)


def _genome(rng, n):
    return "".join(rng.choice(list(BASES), n))


def _planted(rng, n, k):
    out = {}
    for a in rng.choice(np.arange(200, n - 400), k, replace=False).tolist():
        if rng.random() < 0.5:
            out[a] = "".join(rng.choice(list(BASES), int(rng.integers(1, 7))))
        else:
            out[a] = -int(rng.integers(1, 10))
    return out


def _long_input(seed, n_reads, genome_len=29903):
    rng = np.random.default_rng(seed)
    ref = _genome(rng, genome_len)
    planted = _planted(rng, genome_len, 12)
    snps = {}
    for a in list(planted) + rng.integers(100, genome_len - 100, 30).tolist():
        for p in (a - 17, a + 23):  # SNPs beside the indels, in their windows
            snps[p] = BASES[(BASES.index(ref[p]) + 1) % 4]
    reads = [_long_read(rng, ref, int(rng.integers(0, genome_len - 1000)),
                        int(rng.integers(1000, 1401)), planted, snps=snps)
             for _ in range(n_reads)]
    reads.sort(key=lambda r: r[0])
    return ref, _pack(reads, rng)


def _short_input(seed, ref, events, L=100, step=3):
    """Tiles of L bp every `step` over the haplotype of events (sorted
    [(anchor, +ins seq | -del len)]), each read with its exact cigar."""
    rng = np.random.default_rng(seed)
    planted = dict(events)
    reads = []
    for start in range(0, len(ref) - 2 * L, step):
        rs, cig, seq = _long_read(rng, ref, start, L, planted, err=0.0)
        reads.append((rs, cig, seq[:L]))
    fixed = []
    for rs, cig, seq in reads:  # trim the cigar to the L bases kept
        out, q = [], 0
        for op, ln in cig:
            if q >= len(seq):
                break
            if op in (0, 1):
                ln = min(ln, len(seq) - q)
                q += ln
            out.append([op, ln])
        while out[-1][0] != 0:
            op, ln = out.pop()
            if op == 1:
                seq = seq[:-ln]
        fixed.append((rs, out, seq))
    return _pack(fixed, rng, mapq=60)


def _assert_same(ref, inp, threads=4):
    (got, got_e), (want, want_e) = _both(ref, inp, threads)
    assert got_e == want_e
    assert _fields(got) == _fields(want)
    return got


def test_long_reads_match_the_twin():
    ref, inp = _long_input(16, 300)
    recs = _assert_same(ref, inp)
    assert len(recs) >= 5


def test_thread_count_does_not_change_the_output():
    ref, inp = _long_input(17, 200)
    cand, ins_cap = indel._candidates(len(ref), inp)
    codes = caller._BLUT[inp.seq].astype(np.int64)
    raw = np.frombuffer(ref.encode(), np.uint8)
    ref_codes = caller._BLUT[raw].astype(np.uint8)
    outs = [native.indel_sites_native(inp, codes, ref_codes, cand, ins_cap, t)
            for t in (1, 8)]
    assert outs[0][0] == outs[1][0] > 0
    for k, v in outs[0][1].items():
        np.testing.assert_array_equal(v, outs[1][1][k], err_msg=k)
    assert (outs[0][1]["status"] == 1).sum() > 0


@pytest.mark.parametrize("seed", [5, 6])
def test_short_read_tiles_with_multiallelic_indels(seed):
    rng = np.random.default_rng(seed)
    ref = _genome(rng, 1500)
    # two haplotypes at one anchor: a 3 bp and a 5 bp deletion, and an
    # insertion beside a 2 bp deletion
    inp_a = _short_input(seed, ref, [(400, -3), (800, "TCGA")])
    inp_b = _short_input(seed + 1, ref, [(400, -5), (800, "GG"),
                                         (1100, -2)], step=4)
    n_a = len(inp_a.rs)
    inp = IndelInput(
        rs=np.concatenate([inp_a.rs, inp_b.rs]),
        ops=np.concatenate([inp_a.ops, inp_b.ops]),
        lns=np.concatenate([inp_a.lns, inp_b.lns]),
        opoff=np.concatenate([inp_a.opoff, inp_b.opoff[1:] + len(inp_a.ops)]),
        seq=np.concatenate([inp_a.seq, inp_b.seq]),
        quals=np.concatenate([inp_a.quals, inp_b.quals]),
        soff=np.concatenate([inp_a.soff, inp_b.soff[1:] + len(inp_a.seq)]),
        mapq=np.concatenate([inp_a.mapq, inp_b.mapq]),
        rev=np.concatenate([inp_a.rev, inp_b.rev]))
    assert n_a > 0
    recs = _assert_same(ref, inp)
    multi = [r for r in recs if r.pos in (400, 800) and len(r.alts) >= 2]
    assert multi, [(r.pos, r.ref, r.alts) for r in recs]


def _edge_reads(rng, ref, pos):
    """Reads around an insertion and a deletion after `pos`, some of them
    odd: a ref skip, an insertion of N bases, one inside a deletion."""
    reads = []
    for k in range(12):
        s = pos - 60 - 7 * k
        ln = pos + 1 - s
        seq = ref[s : pos + 1] + "AC" + ref[pos + 1 : pos + 61]
        reads.append((s, [[0, ln], [1, 2], [0, 60]], seq))
    for k in range(6):  # insertions whose bases are N: the type is dropped
        s = pos - 50 - 5 * k
        seq = ref[s : pos + 1] + "NNN" + ref[pos + 1 : pos + 40]
        reads.append((s, [[0, pos + 1 - s], [1, 3], [0, 39]], seq))
    for k in range(8):  # a 4 bp deletion
        s = pos - 40 - 3 * k
        seq = ref[s : pos + 1] + ref[pos + 5 : pos + 70]
        reads.append((s, [[0, pos + 1 - s], [2, 4], [0, 65]], seq))
    s = pos - 80  # a ref skip across the site
    reads.append((s, [[0, 70], [3, 30], [0, 40]],
                  ref[s : s + 70] + ref[s + 100 : s + 140]))
    s = pos - 150  # inside a deletion that spans the whole window
    reads.append((s, [[0, 30], [2, 300], [0, 30]],
                  ref[s : s + 30] + ref[s + 330 : s + 360]))
    s = pos - 140  # its aligned bases inside the window: an insertion alone
    reads.append((s, [[0, 30], [2, 100], [1, 5], [2, 200], [0, 30]],
                  ref[s : s + 30] + "GATTA" + ref[s + 330 : s + 360]))
    for k in range(10):  # plain reads, two of them of quality 0
        s = pos - 90 + 9 * k
        reads.append((s, [[4, 5], [0, 120]], "TTTTT" + ref[s : s + 120],
                      *([0] if k < 2 else [])))
    return reads


def _masking_ties(ref, pos):
    """Ten reads over an insertion at pos whose window has three columns of
    3 mismatches: the first seen by 5 reads (60% ALT, masked if it is the
    deepest), the other two by all ten (exactly 70% REF: never masked).
    The deepest ALT locus is the last of the tie.  And a read with a ref
    skip, which no type scores."""
    a, b, c = pos - 40, pos + 5, pos + 15

    def read(s, e, ins, alts):
        seq = list(ref[s:e])
        for p in alts:
            seq[p - s] = BASES[(BASES.index(seq[p - s]) + 1) % 4]
        if ins:
            seq.insert(pos + 1 - s, "T")
            return (s, [[0, pos + 1 - s], [1, 1], [0, e - pos - 1]],
                    "".join(seq))
        return (s, [[0, e - s]], "".join(seq))

    reads = [read(pos - 50, pos + 60, False, [a] if k < 3 else [])
             for k in range(5)]
    reads += [read(pos - 20, pos + 60, k < 3, []) for k in range(5)]
    for k, r in enumerate(reads):  # three reads of the ten differ at b, c
        if k in (0, 5, 8):
            s = r[0]
            seq = list(r[2])
            shift = 1 if r[1][1:2] == [[1, 1]] else 0
            for p in (b, c):
                q = p - s + shift
                seq[q] = BASES[(BASES.index(seq[q]) + 1) % 4]
            reads[k] = (s, r[1], "".join(seq))
    s = pos - 300  # a ref skip before the window: the read is not scored
    reads.append((s, [[0, 40], [3, 200], [0, 63]],
                  ref[s : s + 40] + ref[s + 240 : s + 303]))
    return reads


def _many_types(ref, pos):
    """Two reads of each of six indel types at pos: reads of the fifth and
    sixth best types have no slot."""
    reads = []
    for k, ty in enumerate((1, 2, 3, -1, -2, -3) * 2):
        s = pos - 50 - 4 * k
        if ty > 0:
            seq = ref[s : pos + 1] + "GTCA"[:ty] + ref[pos + 1 : pos + 50]
            cig = [[0, pos + 1 - s], [1, ty], [0, 49]]
        else:
            seq = ref[s : pos + 1] + ref[pos + 1 - ty : pos + 50 - ty]
            cig = [[0, pos + 1 - s], [2, -ty], [0, 49]]
        reads.append((s, cig, seq))
    return reads


def test_edge_cases_match_the_twin():
    rng = np.random.default_rng(9)
    core = _genome(rng, 3000)
    # a repeat-rich stretch for find_STR, an N run after a site, and a long
    # deletion near the end of the reference, past the window
    rep = "AC" * 20 + "AGT" * 10 + "A" * 15 + "CAGCAG" * 5
    ref = core[:600] + rep + core[600:1500] + "N" * 200 + core[1500:2800]
    n = len(ref)
    reads = _edge_reads(rng, ref, 300)
    reads += _edge_reads(rng, ref, 610)  # inside the repeats
    reads += _edge_reads(rng, ref, 1560)  # mostly N after it: the guard
    reads += _many_types(ref, 900)
    for k in range(3):  # only insertions of N bases: no ALT survives
        s = 1200 - 40 - 3 * k
        reads.append((s, [[0, 1201 - s], [1, 2], [0, 30]],
                      ref[s:1201] + "NN" + ref[1201:1231]))
    for k in range(2):  # a leading insertion: no read covers its base
        reads.append((1300, [[1, 3], [0, 50]], "GGG" + ref[1300:1350]))
    for k in range(63):  # 63 insertion lengths at one site: too many types
        s = 2400 - 30 - k
        reads.append((s, [[0, 2401 - s], [1, k + 1], [0, 30]],
                      ref[s:2401] + "T" * (k + 1) + ref[2401:2431]))
    # one read with an insertion and a deletion at one base: one ALT read
    reads.append((2550, [[0, 51], [1, 2], [2, 3], [0, 40]],
                  ref[2550:2601] + "CC" + ref[2604:2644]))
    for k in range(2):  # two insertions among 72 covering reads: under 5%
        reads.append((2660, [[0, 41], [1, 1], [0, 40]],
                      ref[2660:2701] + "G" + ref[2701:2741]))
    for k in range(70):
        reads.append((2640 + k % 20, [[0, 100]],
                      ref[2640 + k % 20 : 2740 + k % 20]))
    end = n - 70
    for k in range(6):  # a deletion reaching past the reference's end
        s = end - 60 - 4 * k
        reads.append((s, [[0, end + 1 - s], [2, 150], [0, 1]],
                      ref[s : end + 1] + "A"))
    for k in range(4):
        s = end - 50 - 5 * k
        reads.append((s, [[0, n - s]], ref[s:]))
    # over 250 covering reads at one site
    for k in range(300):
        s = 2000 - (k % 80)
        if k % 3 == 0:
            reads.append((s, [[0, 2001 - s], [2, 2], [0, 40]],
                          ref[s:2001] + ref[2003:2043]))
        else:
            reads.append((s, [[0, 90]], ref[s : s + 90]))
    reads += _masking_ties(ref, 2200)
    reads.sort(key=lambda r: r[0])
    inp = _pack(reads, rng, mapq=60)
    recs = _assert_same(ref, inp)
    assert {r.pos for r in recs} >= {300, 2000, 2200}
    # the same reads out of start order take the full overlap scan
    perm = rng.permutation(len(reads))
    _assert_same(ref, _pack([reads[i] for i in perm], rng))
    # no read, no indel
    assert _assert_same(ref, _pack(reads[:0], rng)) == []
    plain = [r for r in reads if all(op in (0, 4) for op, _ in r[1])]
    assert _assert_same(ref, _pack(plain, rng)) == []
    one = [(2660, [[0, 41], [1, 1], [0, 40]],
            ref[2660:2701] + "G" + ref[2701:2741])]
    assert _assert_same(ref, _pack(plain + one, rng)) == []


def test_native_glocal_score_equals_the_python_oracle():
    from panmap_tpu_torch.genotype.baq import glocal_score_py

    rng = np.random.default_rng(11)
    for _ in range(60):
        lq = int(rng.integers(1, 160))
        q = rng.integers(0, 5, lq)
        r = q.copy()
        flip = rng.random(lq) < 0.05
        r[flip] = rng.integers(0, 5, flip.sum())
        cut = int(rng.integers(-8, 9))
        r = r[: max(1, lq + cut)] if cut < 0 else np.concatenate(
            [r, rng.integers(0, 4, cut)])
        quals = rng.integers(7, 31, lq)
        bw = int(rng.integers(3, 13))
        want = glocal_score_py(r, q, quals, bw, 1e-4, 1e-2)
        got = native.glocal_score_native(r, q, quals, bw, 1e-4, 1e-2)
        assert got == want, (lq, cut, bw)


def test_without_the_library_the_call_raises_and_names_its_oracle(
        monkeypatch):
    ref, inp = _long_input(18, 20, genome_len=3000)
    depth = np.zeros(len(ref), np.int64)
    monkeypatch.setattr(native, "_lib", False)  # as after a failed build
    monkeypatch.setattr(native, "build_error", "g++: not found")
    monkeypatch.delenv("PANMAP_TPU_NO_NATIVE", raising=False)
    with pytest.raises(RuntimeError, match="g\\+\\+: not found"):
        indel.call_indels_realign(ref, inp, depth, caller._ERRMOD)
    monkeypatch.setenv("PANMAP_TPU_NO_NATIVE", "1")
    with pytest.raises(RuntimeError, match="PANMAP_TPU_NO_NATIVE") as err:
        indel.call_indels_realign(ref, inp, depth, caller._ERRMOD)
    assert "panmap_tpu/genotype/indel.py::call_indels_realign" in str(
        err.value)
