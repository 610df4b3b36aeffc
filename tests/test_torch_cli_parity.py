"""The port's CLI parses every command line of the JAX package's CLI.

Every option string of every subcommand of ``graphsage_tpu.cli``'s
parser must parse through ``graphsage_tpu_torch.cli``'s, and the flags
the two share must land in ``TrainFlags`` alike (the JAX side through
its ``_flags_from_args``). ``--gpu`` and ``--log_device_placement``
are accepted and have no effect, as in the JAX package.
"""

import argparse
import dataclasses

import pytest

from graphsage_tpu import cli as jax_cli
from graphsage_tpu.train.config import TrainFlags as JaxFlags
from graphsage_tpu_torch import cli as port_cli

FLAG_COMMANDS = ("supervised", "unsupervised", "embed", "predict")
# positionals of the subcommands that take them
POSITIONALS = {"eval": ["data/ppi", "feat", "test"],
               "walks": ["data/ppi-G.json", "walks.txt"]}


def _subparsers(parser) -> dict:
    action = next(a for a in parser._actions
                  if isinstance(a, argparse._SubParsersAction))
    return dict(action.choices)


def _base(command: str) -> list:
    if command in POSITIONALS:
        return [command] + POSITIONALS[command]
    return [command, "--train_prefix", "data/ppi"]


def _options(sub) -> list:
    """(option string, action) of every optional argument but help."""
    return [(opt, a) for a in sub._actions if a.option_strings
            and not isinstance(a, argparse._HelpAction)
            for opt in a.option_strings]


def _value(action, default) -> list:
    """Argument tokens that set ``action`` to a value other than
    ``default`` (the subcommand's), or [] for flags without one."""
    if action.nargs == 0:
        return []
    if action.choices:
        return [next(str(c) for c in action.choices if c != default)]
    if action.type is int:
        return [str((default or 0) + 1)]
    if action.type is float:
        return [str((default or 0.0) + 0.25)]
    return [f"alt_{action.dest}"]


JAX_SUBS = _subparsers(jax_cli.build_parser())


@pytest.mark.parametrize("command", sorted(JAX_SUBS))
def test_every_jax_option_parses(command):
    """Each option string of the JAX subcommand, alone after the
    required arguments, parses through the port's parser."""
    port = port_cli.build_parser()
    for opt, action in _options(JAX_SUBS[command]):
        if opt == "--train_prefix":
            continue
        argv = _base(command) + [opt] + _value(action, action.default)
        try:
            args = port.parse_args(argv)
        except SystemExit as exc:   # argparse's exit 2
            pytest.fail(f"the port refuses {argv}: exit {exc.code}")
        assert args.command == command


def _jax_defaults(command: str) -> JaxFlags:
    if command in ("unsupervised", "embed"):
        return JaxFlags(learning_rate=0.00001, epochs=1, max_degree=100,
                        print_every=50)
    return JaxFlags()


def _shared_argv(command: str) -> list:
    """A command line that sets every flag the two subcommands share
    (``--train_prefix`` among them) to a non-default value."""
    jax_sub = JAX_SUBS[command]
    port_opts = {opt for opt, _ in _options(
        _subparsers(port_cli.build_parser())[command])}
    argv = [command]
    for action in jax_sub._actions:
        if (not action.option_strings
                or isinstance(action, argparse._HelpAction)):
            continue
        opts = [o for o in action.option_strings if o in port_opts]
        if not opts:
            continue
        if isinstance(action, argparse.BooleanOptionalAction):
            argv.append(f"--no-{action.dest}" if action.default
                        else f"--{action.dest}")
            continue
        argv += [opts[0]] + _value(action, action.default)
    return argv


def _flags_both(argv: list):
    jax_args = jax_cli.build_parser().parse_args(argv)
    port_args = port_cli.build_parser().parse_args(argv)
    want = jax_cli._flags_from_args(jax_args, _jax_defaults(argv[0]))
    return dataclasses.asdict(want), dataclasses.asdict(
        port_cli.flags_from_args(port_args))


@pytest.mark.parametrize("command", FLAG_COMMANDS)
def test_shared_flags_land_alike(command):
    argv = _shared_argv(command)
    # every TrainFlags field the JAX subcommand takes is set off default
    want, got = _flags_both(argv)
    defaults = dataclasses.asdict(_jax_defaults(command))
    jax_dests = {a.dest for a in JAX_SUBS[command]._actions}
    moved = {k for k in want if want[k] != defaults[k]}
    assert moved == jax_dests & set(defaults)
    assert got == want


@pytest.mark.parametrize("command", FLAG_COMMANDS)
def test_default_flags_land_alike(command):
    want, got = _flags_both([command, "--train_prefix", "data/ppi"])
    assert got == want


@pytest.mark.parametrize("command", FLAG_COMMANDS)
def test_gpu_flags_have_no_effect(command):
    base = [command, "--train_prefix", "data/ppi", "--dropout", "0.5"]
    parser = port_cli.build_parser()
    plain = port_cli.flags_from_args(parser.parse_args(base))
    with_gpu = port_cli.flags_from_args(parser.parse_args(
        base + ["--gpu", "0", "--log_device_placement"]))
    assert with_gpu == plain


def test_gpu_flags_hidden_and_device_named():
    sub = _subparsers(port_cli.build_parser())["supervised"]
    text = sub.format_help()
    assert "[--gpu" not in text and "--log_device_placement" not in text
    assert "cuda:<i> picks the card" in " ".join(text.split())
