"""The fleet and audit chaos drills of the port (sbr_tpu_torch.resilience.
chaos ``--fleet`` and ``--audit``) on the CPU: each exits 0 with
``"ok": true`` and the reference's ``checks`` keys (tests/torch_chaos.py).

- ``--fleet``: one of three worker processes SIGKILLed under load, no
  query lost, the answers byte-identical to a single-worker run, the
  failover, breaker and trace joins visible through the report CLI;
- ``--audit``: worker 0's ``graphgen.layout`` canary corrupted, drift
  within two cycles, worker 0 quarantined, answers byte-identical, and no
  drift on the clean audited run.

The drills compare five answer fields, as the reference's do; the answer
files they leave are held here to the sixth, ``residual``, as well.
"""

import json

import pytest

import torch_chaos as tc

# each compared run's answer file against its ground truth's
ANSWER_PAIRS = {"fleet": (("fleet_solo", "fleet_churn"),),
                "audit": (("audit_off", "audit_clean"), ("audit_off", "audit_fault"))}


@pytest.mark.parametrize("drill", ["fleet", "audit"])
def test_serving_drill_passes_on_the_cpu(drill, tmp_path):
    rc, doc, _seconds = tc.run_drill(drill, tmp_path / drill)
    failed = [k for k, v in (doc.get("checks") or {}).items() if not v]
    assert rc == 0 and doc.get("ok") is True, (failed, doc)
    assert list(doc["checks"]) == tc.check_keys(tc.REFERENCE, tc.DRILLS[drill][0])
    for ref, other in ANSWER_PAIRS[drill]:
        a, b = (json.loads((tmp_path / drill / f"{n}_answers.json").read_text())
                for n in (ref, other))
        assert len(a) == len(b) > 0
        assert [x["residual"] for x in a] == [y["residual"] for y in b], other
