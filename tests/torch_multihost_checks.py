"""The checks of the multi-controller matrix, shared by
tests/test_torch_multihost_2.py and tests/test_torch_multihost_4.py:
each imports them and defines the module fixture ``mh`` (the dict of
``torch_multihost_matrix.run_matrix`` at its rank count).  The port's
twins of tests/test_multihost.py's checks, each a test of its own."""
import numpy as np

from torch_multihost_matrix import EXIT_FAULT, EXIT_STALLED, FIELDS, same


def test_run_matches_reference(mh):
    """An N-rank run == the reference's spmd driver on N devices, field
    for field (edge_part, vparts, edges_per_part, rounds, leftover)."""
    assert same(mh["res_a"], mh["ref"])


def test_run_matches_port_partition_spmd(mh):
    """== the port's own partition_spmd at world N."""
    assert same(mh["res_a"], mh["port_spmd"])


def test_distributed_metrics_match_evaluate(mh):
    """RF / EB / VB from the sharded finalize's (P,) partials equal
    evaluate() of the reference's full assignment."""
    st, t = mh["ref_stats"], mh["timing_a"]
    assert t["replication_factor"] == st.replication_factor
    assert t["edge_balance"] == st.edge_balance
    assert t["vertex_balance"] == st.vertex_balance


def test_snapshots_byte_identical_to_reference(mh):
    """Every round's multi-writer step dir has the bytes of the
    reference's single-writer step dir at N devices."""
    assert mh["snapshots_bit_identical"]


def test_traced_run_artifacts(mh):
    """A rank's JSONL log each, one merged Chrome trace, and a report
    with round percentiles, phases, payload bytes and per-rank peak RSS."""
    assert mh["trace_per_host_logs"]
    assert mh["trace_chrome_valid"]
    assert mh["report_fields_ok"]


def test_obs_reads_the_run_as_the_reference_does(mh):
    """The reference's exporter, report and monitor read the port's logs
    of run A to the same trace, summary and verdict."""
    from repro.obs import export as jexport
    from repro.obs import monitor as jmon
    from repro.obs import report as jreport
    from repro_torch.obs import export, monitor, report

    logs = mh["trace_logs"]
    assert export.chrome_trace(logs) == jexport.chrome_trace(logs)
    run = logs[0].parent
    got, want = report.summarize_run(run), jreport.summarize_run(run)
    assert got == want and report.render(got) == jreport.render(want)
    cfg = dict(stall_after=1e9, dead_after=1e9)
    a = monitor.BusMonitor(mh["live_dir"], monitor.MonitorConfig(**cfg))
    b = jmon.BusMonitor(mh["live_dir"], jmon.MonitorConfig(**cfg))
    a.poll()
    b.poll()
    now = 2e9
    sa, sb = a.assess(now=now), b.assess(now=now)
    assert sa == sb and sa["overall"] == "done"
    assert monitor.render_prometheus(sa) == jmon.render_prometheus(sb)


def test_live_monitor_observes_healthy_run(mh):
    """A monitor attached while run A runs sees a heartbeat from every
    rank, rounds strictly monotone, every rank done, and
    ``monitor_run --once`` exits 0."""
    assert mh["monitor_hosts_ok"]
    assert mh["monitor_rounds_monotone"]
    assert mh["monitor_live_exit"]


def test_live_quality_matches_finalized_metrics(mh):
    assert mh["monitor_rf_matches_final"]


def test_kill_one_rank_fails_the_gang(mh):
    """Rank 1 exits 17 after round k's publish; the launcher returns 17."""
    assert mh["kill_rc"] == EXIT_FAULT
    assert mh["kill_published"][-1] == mh["kill_round"]


def test_killed_run_flips_monitor_to_stalled(mh):
    assert mh["monitor_kill_rc"] == EXIT_STALLED


def test_kill_then_resume_bit_identity(mh):
    assert mh["timing_c"]["resume_round"] == mh["kill_round"]
    assert same(mh["res_c"], mh["ref"])


def test_torn_snapshot_round_is_skipped(mh):
    """A kill between staging and publish never publishes round k; the
    resume falls back to round k - 1 and ends on the same bits."""
    k = mh["kill_round"]
    assert mh["torn_rc"] == EXIT_FAULT
    assert mh["torn_published"][-1] == k - 1
    assert mh["timing_e"]["resume_round"] == k - 1
    assert same(mh["res_e"], mh["ref"])


def test_single_writer_driver_resumes_multiwriter_snapshots(mh):
    """The spmd driver at world 1 (no exchange) resumes A's N-rank
    snapshots, resharding them in memory."""
    assert same(mh["res_f"], mh["ref"])


def test_sharded_finalize_never_materializes(mh):
    """With REPRO_FORBID_EDGE_PART_MATERIALIZE set the run and its
    multi-writer artifact complete."""
    assert mh["forbid_rc"] == 0


def test_multiwriter_artifact_bit_identical(mh):
    """Its artifact has the bytes of the reference's single-writer
    save_artifact of the reference result."""
    assert mh["artifact_bit_identical"]


def test_elastic_resume_at_the_other_world_size(mh):
    """B's round-k snapshot resumed at the other rank count (2 <-> 4)
    through the store-backed reshard: the same bits, from round k."""
    assert mh["timing_h"]["resume_round"] == mh["kill_round"]
    assert same(mh["res_h"], mh["ref"])


def test_reference_driver_resumes_port_snapshot(mh):
    """The reference's spmd driver on N devices resumes the port's
    round-k multi-writer snapshot to the same result."""
    assert same(mh["ref_resumed"], mh["ref"])
    assert all(np.array_equal(mh["ref_resumed"][f], mh["res_a"][f])
               for f in FIELDS)
