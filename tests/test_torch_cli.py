"""The port's CLI (halo2_zkcert_tpu_torch/cli.py) against the JAX package's:
the same 11 subcommands with the same defaults (`--device`, default cuda,
apart), an unknown command refused, and `gen-params` writing the JAX CLI's
SRS bytes and reading its cache on a second call.  `download-tls-certs` is
checked for its arguments and its wiring only: it needs the network."""
import argparse
import os

import pytest
import torch

from halo2_zkcert_tpu import cli as jcli
from halo2_zkcert_tpu_torch import cli

torch.set_num_threads(2)

REQUIRED = {"download-tls-certs": ["--domain", "example.com"]}


def _subcommands(parser):
    for act in parser._actions:
        if isinstance(act, argparse._SubParsersAction):
            return list(act.choices)
    raise AssertionError("no subcommands")


def test_eleven_subcommands_as_the_jax_cli():
    names = _subcommands(cli.build_parser())
    assert names == _subcommands(jcli.build_parser())
    assert len(names) == 11


@pytest.mark.parametrize("cmd", _subcommands(jcli.build_parser()))
def test_defaults_equal_the_jax_cli(cmd):
    argv = [cmd] + REQUIRED.get(cmd, [])
    got = vars(cli.build_parser().parse_args(argv))
    want = vars(jcli.build_parser().parse_args(argv))
    if cmd == "download-tls-certs":
        assert "device" not in got
    else:
        assert got.pop("device") == "cuda"
    assert got == want


def test_help_lists_the_subcommands(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert all(name in out for name in _subcommands(cli.build_parser()))


@pytest.mark.parametrize("argv", [["no-such-command"], [],
                                  ["download-tls-certs"],
                                  ["gen-params", "--k", "six"]])
def test_bad_command_lines_refused(argv, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code == 2


def test_download_tls_certs_wiring(monkeypatch, capsys, tmp_path):
    from halo2_zkcert_tpu_torch import cert
    calls = []
    monkeypatch.setenv("PARAMS_DIR", str(tmp_path))  # restored after the test
    monkeypatch.setattr(cert, "download_tls_certs_from_domain",
                        lambda domain, out: calls.append((domain, out))
                        or [f"{out}/cert_2.pem", f"{out}/cert_1.pem"])
    cli.main(["download-tls-certs", "--domain", "example.com",
              "--certs-path", str(tmp_path)])
    assert calls == [("example.com", str(tmp_path))]
    assert capsys.readouterr().out.split() == [f"{tmp_path}/cert_2.pem",
                                               f"{tmp_path}/cert_1.pem"]


def test_gen_params_writes_the_jax_srs_and_reads_its_cache(
        tmp_path, monkeypatch, capsys):
    from halo2_zkcert_tpu_torch.plonk import kzg
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    monkeypatch.setenv("PARAMS_DIR", str(mine))     # restored after the test
    cli.main(["gen-params", "--k", "6", "--device", "cpu",
              "--params-path", str(mine), "--build-dir",
              str(tmp_path / "build")])
    assert capsys.readouterr().out.strip() == f"srs k=6 cached in {mine}"
    jcli.main(["gen-params", "--k", "6", "--params-path", str(theirs),
               "--build-dir", str(tmp_path / "build")])
    name = "kzg_bn254_6.srs"
    assert (mine / name).read_bytes() == (theirs / name).read_bytes()

    def no_setup(*a, **k):
        raise AssertionError("the cached SRS was not read")
    monkeypatch.setattr(kzg, "setup", no_setup)
    before = os.path.getmtime(mine / name)
    cli.main(["gen-params", "--k", "6", "--device", "cpu",
              "--params-path", str(mine), "--build-dir",
              str(tmp_path / "build")])
    assert os.path.getmtime(mine / name) == before


def test_aggregation_step_refuses_other_commands():
    with pytest.raises(ValueError):
        cli.aggregation_step("gen-x509-agg-keys", None, None, None, None)
