"""Eval-mode drivers: all-vs-all, PCA-filtered, and debug-recall modes.

Dispatch mirrors ntsmEval's main (src/ntSeqMatchEval.cpp:304-341) and
computeScorePCA (src/CompareCounts.hpp:285-528).
"""

from __future__ import annotations

import sys

import numpy as np

from ntsm_tpu.eval import exact
from ntsm_tpu.eval.exact import HEADER, PairResult, pair_score, results_row
from ntsm_tpu.eval.model import CountData
from ntsm_tpu.eval.pca import (
    DBL_MAX,
    calc_distance_sq,
    pca_candidates,
    project_pcs,
    search_radii,
    sq_dists_blocked,
)
from ntsm_tpu.options import Options
from ntsm_tpu.utils.formats import cpp_to_string


def compute_score_pca(data: CountData, opts: Options, out, cloud: np.ndarray) -> None:
    """PCA-filtered comparison (computeScorePCA, CompareCounts.hpp:285-391)."""
    radii = search_radii(data, opts)
    out.write(HEADER)
    out.write("\n")
    pairs = list(pca_candidates(cloud, radii, opts.dim))
    if pairs:
        from ntsm_tpu.eval.exact import _emit_pairs, native_pair_stats

        ii = np.fromiter((p[0] for p in pairs), np.int32, len(pairs))
        jj = np.fromiter((p[1] for p in pairs), np.int32, len(pairs))
        got = native_pair_stats(data, opts, ii, jj)
        if got is not None:
            score, tallies = got
            d = cloud[ii, : opts.dim] - cloud[jj, : opts.dim]
            dist = (d * d).sum(axis=1)
            _emit_pairs(data, opts, out, ii, jj, score, tallies, dist=dist)
            return
    for i, k in pairs:
        score, nv, rel = pair_score(data, i, k, opts)
        if opts.all or score < opts.score_thresh:
            dist = cpp_to_string(calc_distance_sq(cloud, i, k, opts.dim))
            res = PairResult(i=i, j=k, score=score, n=nv, relate=rel)
            out.write(results_row(data, res, dist, opts))
            out.write("\n")


def compute_score_pca_debug(
    data: CountData, opts: Options, out, cloud: np.ndarray
) -> None:
    """Debug recall harness for the PCA heuristic (-b;
    CompareCounts.hpp:392-527): given ground-truth same-origin groups,
    report per true pair how many candidate pairs the heuristic would
    evaluate at that distance and whether each sample's radius tier covers
    the pair."""
    radii = search_radii(data, opts)
    file_to_id = {name: i for i, name in enumerate(data.filenames)}
    true_pairs: list[tuple[int, int]] = []
    seen = set()
    with open(opts.debug) as fh:
        for line in fh:
            values = line.split()
            for a in range(len(values)):
                for b in range(a + 1, len(values)):
                    for v in (values[a], values[b]):
                        if v not in file_to_id:
                            print(f"missing file {v}", file=sys.stderr)
                    x = file_to_id[values[a]]
                    y = file_to_id[values[b]]
                    p = (x, y) if x <= y else (y, x)
                    if p not in seen:
                        seen.add(p)
                        true_pairs.append(p)

    out.write(HEADER)
    out.write("\tpairs\tcandidates1\tcandidates2\tpossible\tradius1\tradius2\tcorrect\n")
    if opts.all:
        # reference order (CompareCounts.hpp:312-434): headers and the
        # truth file land BEFORE the -a rejection, so stdout carries the
        # header line when it exits
        print("Currently unable to output all pairs in debug mode.", file=sys.stderr)
        raise SystemExit(1)

    c = cloud[:, : opts.dim]
    sq = sq_dists_blocked(c)
    n = data.n_samples

    def pruned_candidates(x: int) -> int:
        cnt = 0
        for k in np.nonzero(sq[x] < radii[x])[0]:
            k = int(k)
            if radii[x] == radii[k]:
                if k <= x:
                    continue
            elif radii[x] < radii[k]:
                continue
            cnt += 1
        return cnt

    for x, y in true_pairs:
        score, nv, rel = pair_score(data, x, y, opts)
        distance = calc_distance_sq(cloud, x, y, opts.dim)
        # pairs evaluated at this distance across all query points
        pairs = int(sum(((sq[i] < distance) & (np.arange(n) > i)).sum() for i in range(n)))
        res = PairResult(i=x, j=y, score=score, n=nv, relate=rel)
        out.write(results_row(data, res, cpp_to_string(distance), opts))
        out.write(
            "\t"
            + "\t".join(
                [
                    str(pairs),
                    str(pruned_candidates(x)),
                    str(pruned_candidates(y)),
                    str(len(data.filenames) - 1),
                    cpp_to_string(radii[x]),
                    cpp_to_string(radii[y]),
                    "1",
                ]
            )
        )
        out.write("\n")


def run_eval(data: CountData, opts: Options, out) -> None:
    """Top-level dispatch (ntSeqMatchEval.cpp:304-341)."""
    from ntsm_tpu.eval.merge import merge_counts

    if data.n_samples == 1:
        cloud = None
        if opts.pca:
            cloud = project_pcs(data, opts)[:, : opts.dim]
        exact.compute_score_single(data, opts, out, cloud=cloud)
        return
    if opts.only_merge:
        if not opts.merge:
            print("(-l) cannot be used without --merge (-e) option.", file=sys.stderr)
            raise SystemExit(1)
        print(" (-l) option detected. Not performing analysis, only merging.", file=sys.stderr)
    else:
        if not opts.pca:
            print(
                "Performing all-to-all score computation.\n"
                "Specify -p (--pca) to enable faster comparisons.",
                file=sys.stderr,
            )
            if opts.engine == "tpu":
                from ntsm_tpu.eval.tpu import compute_score_all_tpu

                compute_score_all_tpu(data, opts, out)
            else:
                exact.compute_score_all(data, opts, out)
        else:
            # streaming -p engine: attached by the wire loader when the
            # whole filtered pipeline (projection, tiers, candidate
            # decisions, device pair scoring) already ran DURING the
            # parse — only the reference-order enumeration and emission
            # remain (eval/pca_stream.py).  Falls back to the serial
            # phases on any stream failure.
            eng = getattr(data, "pca_stream", None)
            if eng is not None:
                data.pca_stream = None
                if opts.debug or getattr(opts, "engine", "exact") != "tpu":
                    eng.abort()
                    eng = None
                else:
                    try:
                        eng.join()
                    except BaseException as e:  # noqa: BLE001
                        print(
                            f"ntsm eval: -p stream failed ({e}); "
                            "falling back to the serial path",
                            file=sys.stderr,
                        )
                        eng = None
            if eng is not None:
                from ntsm_tpu.eval.exact import HEADER

                out.write(HEADER)
                out.write("\n")
                eng.result_rows(data, opts, out)
            else:
                cloud = project_pcs(data, opts)
                if opts.debug:
                    compute_score_pca_debug(data, opts, out, cloud)
                elif getattr(opts, "engine", "exact") == "tpu":
                    # device pair-block scoring of the candidate set —
                    # same pairs/order as the host loop, O(candidates ·
                    # sites) on the device (reference pair loop:
                    # CompareCounts.hpp:335-356)
                    from ntsm_tpu.eval.tpu import compute_score_pca_tpu

                    compute_score_pca_tpu(data, opts, out, cloud)
                else:
                    compute_score_pca(data, opts, out, cloud)
    if opts.merge:
        merge_counts(data, opts.merge)
