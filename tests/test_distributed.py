"""Multi-host launch surface: flag/env handling + the gated dryrun."""

import os

import pytest

from csa_jax.parallel import distributed


def test_initialize_noop_without_coordinator(monkeypatch):
    """No coordinator flag/env -> quiet single-process fallback
    (returns False, touches nothing)."""
    monkeypatch.delenv("CSA_COORDINATOR", raising=False)
    assert distributed.initialize() is False


def test_env_values_parsed(monkeypatch):
    """CSA_* env values reach jax.distributed.initialize."""
    seen = {}

    class FakeDist:
        @staticmethod
        def initialize(coordinator_address=None, num_processes=None,
                       process_id=None):
            seen.update(
                coordinator=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
            )

    import jax

    monkeypatch.setenv("CSA_COORDINATOR", "h0:1234")
    monkeypatch.setenv("CSA_NUM_PROCESSES", "3")
    monkeypatch.setenv("CSA_PROCESS_ID", "1")
    monkeypatch.setattr(jax, "distributed", FakeDist)
    monkeypatch.setattr(jax, "process_count", lambda: 3, raising=False)
    assert distributed.initialize() is True
    assert seen == {
        "coordinator": "h0:1234", "num_processes": 3, "process_id": 1
    }


@pytest.mark.skipif(
    not os.environ.get("CSA_SLOW_TESTS"),
    reason="set CSA_SLOW_TESTS=1 for the multi-process dryrun",
)
def test_multiprocess_dryrun_parity():
    res = distributed.run_multiprocess_dryrun()
    assert res.get("ok"), res
    assert res.get("parity_vs_single_process") is True
    assert res.get("ladder_parity_cross_process") is True
