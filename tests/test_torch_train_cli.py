"""The port's train CLI takes the reference's ``--shape`` and
``--smoke`` / ``--full`` flags (``repro.launch.train``): parsed as
there, and a SMOKE run on the CPU through ``--shape``."""
import pytest

from repro_torch.launch import train


@pytest.mark.parametrize("argv,smoke", [([], None), (["--smoke"], True),
                                        (["--full"], False),
                                        (["--smoke", "--full"], False),
                                        (["--full", "--smoke"], True)])
def test_smoke_and_full_flags(argv, smoke):
    args = train.parse_args(argv)
    assert args.smoke is smoke and args.shape == "train_4k"


def test_smoke_run_through_the_shape_flag(capsys):
    hist = train.main(["--device", "cpu", "--smoke", "--shape", "train_4k",
                       "--arch", "smollm-360m", "--steps", "2", "--batch",
                       "4", "--seq", "16", "--log-every", "1"])
    out = capsys.readouterr().out
    assert len(hist) == 2 and "done: 2 steps" in out
    assert out.startswith("smollm-360m (2 layers")
    assert "batch 4 x seq 16" in out


def test_shape_flag_takes_train_shapes_only():
    with pytest.raises(ValueError, match="train shapes only"):
        train.main(["--device", "cpu", "--smoke", "--shape", "prefill_32k",
                    "--steps", "1"])
