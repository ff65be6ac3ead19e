"""``repro_torch.dist.run_ranks`` under failure and concurrency, on the CPU
with gloo: a rank process that dies without reporting stops the run within
seconds and its exit code reaches the caller (``RankFailure.exit_codes``,
what the fleet's worker maps to its own exit code), and two runs started at
once never collide on the port of their rendezvous."""

import os
import socket
import threading
import time

import pytest
# without torch the port's tests skip, and the imports below wait for it
# ruff: noqa: E402
torch = pytest.importorskip("torch")

import torch.distributed as tdist

from repro_torch import dist


def _die_on_rank_1(ctx):
    if ctx.rank == 1:
        os._exit(13)
    time.sleep(600)  # busy elsewhere: never notices its peer's death


def _all_exit_13(ctx):
    tdist.barrier()
    os._exit(13)


def _raise_on_rank_1(ctx):
    if ctx.rank == 1:
        raise ValueError("rank 1 refuses")
    time.sleep(600)


def _rank_sum(ctx, k):
    return float(dist.all_reduce(torch.tensor(float(ctx.rank + k)), "sum"))


def test_a_rank_that_exits_without_a_result_stops_the_run():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as info:
        dist.run_ranks(_die_on_rank_1, 2, 1, device="cpu", timeout=60)
    assert time.monotonic() - t0 < 30
    err = info.value
    assert isinstance(err, dist.RankFailure)
    assert "rank 1 of 2x1 exited with code 13" in str(err)
    assert err.rank == 1
    # rank 0 slept on: stopped here, by SIGTERM
    assert err.exit_codes == {0: -15, 1: 13}


def test_every_rank_exit_code_reaches_the_caller():
    # the fleet's kill: every rank passes a barrier, then exits with 13
    with pytest.raises(dist.RankFailure) as info:
        dist.run_ranks(_all_exit_13, 2, 1, device="cpu", timeout=60)
    assert info.value.exit_codes == {0: 13, 1: 13}
    # a rank that raises reports its traceback and exits 1
    with pytest.raises(dist.RankFailure, match="rank 1 of 2x1 failed") as info:
        dist.run_ranks(_raise_on_rank_1, 2, 1, device="cpu", timeout=60)
    assert "ValueError: rank 1 refuses" in str(info.value)
    assert info.value.rank == 1 and info.value.exit_codes == {0: -15, 1: 1}


def test_concurrent_runs_both_succeed():
    outs, errors = {}, []

    def run(k):
        try:
            outs[k] = dist.run_ranks(_rank_sum, 2, 1, device="cpu",
                                     args=(k,), timeout=120)
        except BaseException as e:  # re-raised below, in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(k,)) for k in (10, 20)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert outs == {10: [21.0, 21.0], 20: [41.0, 41.0]}


def test_the_rendezvous_port_is_never_let_go(monkeypatch):
    # whatever port this process binds and releases is taken at once by
    # another listener, as a concurrent run or any other program could:
    # run_ranks must hold the port its ranks meet on until they have met
    real = socket.socket
    stolen = []

    class Thief(real):
        def close(self):
            try:
                port = self.getsockname()[1]
            except OSError:
                port = 0
            super().close()
            if port:
                s = real()
                s.bind(("localhost", port))
                s.listen()
                stolen.append(s)

    monkeypatch.setattr(socket, "socket", Thief)
    try:
        assert dist.run_ranks(_rank_sum, 2, 1, device="cpu", args=(0,),
                              timeout=60) == [1.0, 1.0]
    finally:
        for s in stolen:
            s.close()
