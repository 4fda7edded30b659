"""The spawned-server drills of the port: the counterparts of the
reference's ``bench/wire_chaos.py`` (``wire_chaos``), ``bench/serve_load.py``'s
``Server`` (``spawned``) and the gates of ``bench/telemetry_live_selftest.py``,
``bench/chaos_serve_selftest.py``, ``bench/durability_selftest.py`` and the
sentinel cells of ``bench/doctor_selftest.py`` (``drills``).  They import
only the port; ``chip_smoke.py`` phase 3n runs them against a server
process on the card, and the tests against one on CPU ranks."""
