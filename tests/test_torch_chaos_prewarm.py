"""The prefetch chaos drill of the port (sbr_tpu_torch.resilience.chaos
``--prewarm``) on the CPU: a sweeper hung and SIGKILLed holding a tile
lease, the stranded tile adopted by a second sweeper at the 2 s lease TTL,
the solver outage answered from the tile cache byte for byte, and the
controller never imported with ``SBR_PREWARM=0``. It exits 0 with
``"ok": true`` and the reference's ``checks`` keys (tests/torch_chaos.py).
"""

import torch_chaos as tc


def test_prewarm_drill_passes_on_the_cpu(tmp_path):
    rc, doc, _seconds = tc.run_drill("prewarm", tmp_path / "prewarm")
    assert rc == 0 and doc.get("ok") is True, (
        [k for k, v in (doc.get("checks") or {}).items() if not v], doc)
    assert list(doc["checks"]) == tc.check_keys(tc.REFERENCE, "main_prewarm")
