"""``launch.train --autotune`` on the CPU: the SMOKE rwkv6 for 4 steps
with a probe every 2, against the same run without ``--autotune``.  The
probes run outside the timed step and leave the training untouched:
the losses are bit for bit those of the run without them."""

from repro_torch.launch import train as T

ARGS = ["--arch", "rwkv6_1_6b", "--smoke", "--device", "cpu", "--steps",
        "4", "--batch", "2", "--seq", "32", "--log-every", "1"]


def test_train_autotune_probes_and_keeps_the_losses(capsys):
    plain = T.run(T.parse_args(ARGS))
    assert plain.tuner is None
    capsys.readouterr()
    tuned = T.run(T.parse_args(ARGS + ["--autotune", "--autotune-every",
                                       "2"]))
    out = capsys.readouterr().out
    tuner = tuned.tuner
    assert tuned.losses == plain.losses  # bit for bit
    assert tuner.executions == 2  # steps 0 and 2
    assert tuner.reservoir_sizes() == {"stacked": 2}
    assert tuner.mesh_fingerprint == "train-online"
    assert [r.reason for r in tuner.history] == ["not_due", "not_due"]
    for s in tuner.reservoir("stacked"):
        # the probe: add over max(2, data degree) ranks, 8 bytes an expert
        # slot (the dense config: 8 slots)
        assert (s.kind, s.p, s.nbytes, s.clock) == \
            ("exclusive", 2, 64, "online")
        assert s.seconds > 0
    assert ("[autotune] refits=0 installs=0 plans_dropped=0 "
            "reservoirs={'stacked': 2}") in out
