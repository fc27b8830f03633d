"""The port's daemon (shredword_tpu_torch/daemon.py): tests/test_daemon.py
mirrored on the port (server in a subprocess, thin clients here,
commands with --device cpu), its own socket and environment variables
(a client of one package never reaches the other's server), and the
four faults of the JAX package's daemon that the port does not have:
a string SystemExit code, the socket's mode at bind, the lock file's
unlink, and stop() on a busy server."""

import fcntl
import io
import os
import socket
import stat
import subprocess
import sys
import time
from contextlib import redirect_stdout

import pytest

from shredword_tpu import cli as jax_cli
from shredword_tpu import daemon as jax_daemon
from shredword_tpu_torch import cli, daemon
from shredword_tpu_torch.cli import main

pytestmark = pytest.mark.skipif(
    not hasattr(os, "getuid"), reason="unix-socket daemon")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT = "the quick brown fox jumps over the lazy dog"


def _spawn(sock: str, log_path: str, idle: str = "600", **env_extra):
    env = dict(os.environ)
    env.pop(daemon.IN_DAEMON_ENV, None)
    env.update(env_extra)
    log = open(log_path, "ab")
    proc = subprocess.Popen(
        [sys.executable, "-m", "shredword_tpu_torch", "daemon", "serve",
         "--socket", sock, "--idle-timeout", idle],
        stdout=log, stderr=log, stdin=subprocess.DEVNULL, env=env, cwd=ROOT)
    log.close()
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        if daemon.ping(sock):
            return proc
        if proc.poll() is not None:
            raise RuntimeError("daemon died: "
                               + open(log_path).read()[-2000:])
        time.sleep(0.2)
    proc.kill()
    proc.wait(timeout=30)
    raise RuntimeError("daemon did not come up")


def _stop(sock: str, proc) -> None:
    daemon.stop(sock)
    proc.wait(timeout=60)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    """A live port daemon.  Hostile environment: routing on and pointed
    at this daemon's own socket, so serve() must keep the commands it
    handles local."""
    d = tmp_path_factory.mktemp("torch_daemon")
    sock = str(d / "d.sock")
    proc = _spawn(sock, str(d / "d.log"), **{daemon.ROUTE_ENV: "1",
                                             daemon.SOCKET_ENV: sock})
    yield sock
    _stop(sock, proc)


def test_ping(server):
    assert daemon.ping(server)
    assert not daemon.ping(server + ".nonexistent")


def test_train_and_encode_via_daemon(server, small_corpus_file, tmp_path):
    model = str(tmp_path / "m.model")
    vocab = str(tmp_path / "m.vocab")
    argv = ["train", "--corpus", small_corpus_file, "--model", model,
            "--vocab", vocab, "--vocab-size", "300", "--min-pair-freq", "2",
            "--device", "cpu"]
    r = daemon.request(argv, socket_path=server)
    assert r is not None and r["rc"] == 0, r
    assert "trained" in r["stdout"]
    with open(model, "rb") as f:
        via_daemon = f.read()
    assert main([*argv[:4], str(tmp_path / "l.model"), *argv[5:]]) == 0
    assert open(tmp_path / "l.model", "rb").read() == via_daemon

    # encode through the daemon == encode in-process
    r2 = daemon.request(["encode", "--model", model, "--input", "-",
                         "--device", "cpu"], socket_path=server,
                        stdin_text=TEXT)
    assert r2 is not None and r2["rc"] == 0, r2
    buf = io.StringIO()
    old_stdin = sys.stdin
    try:
        sys.stdin = io.StringIO(TEXT)
        with redirect_stdout(buf):
            rc = main(["encode", "--model", model, "--device", "cpu"])
    finally:
        sys.stdin = old_stdin
    assert rc == 0
    assert r2["stdout"] == buf.getvalue()


def test_bad_command_keeps_daemon_alive(server):
    r = daemon.request(["info", "/nonexistent/model/path.model"],
                       socket_path=server)
    assert r is not None and r["rc"] != 0
    assert "Traceback" in r["stderr"]
    assert daemon.ping(server)          # still serving


def test_argparse_error_returns_rc(server):
    r = daemon.request(["train"], socket_path=server)  # missing required
    assert r is not None and r["rc"] == 2
    assert "required" in r["stderr"]
    assert daemon.ping(server)


def test_env_routing_falls_back_without_daemon(tmp_path, monkeypatch):
    """Routing on with an unreachable socket and a failing auto-start
    falls back to running locally (no recursion, no hang): the local
    path's own exception surfaces."""
    monkeypatch.setenv(daemon.ROUTE_ENV, "1")
    monkeypatch.setenv(daemon.SOCKET_ENV, str(tmp_path / "nope" / "x.sock"))
    monkeypatch.setattr(daemon, "start", lambda *a, **k: False)
    with pytest.raises(FileNotFoundError):
        main(["info", str(tmp_path / "missing.model")])


def test_second_serve_refuses_to_steal_socket(server):
    p = subprocess.run(
        [sys.executable, "-m", "shredword_tpu_torch", "daemon", "serve",
         "--socket", server, "--idle-timeout", "5"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert p.returncode == 1
    assert "another server owns" in p.stdout
    assert daemon.ping(server)          # original still serving


def test_alive_connect_probe(server, tmp_path):
    assert daemon.alive(server)
    assert not daemon.alive(str(tmp_path / "missing.sock"))


def test_env_routing_through_daemon(server, monkeypatch, capsys):
    """Routing on: a command runs in the live daemon, which relays its
    stdout, stderr and exit code."""
    monkeypatch.setenv(daemon.ROUTE_ENV, "1")
    monkeypatch.setenv(daemon.SOCKET_ENV, server)
    monkeypatch.delenv(daemon.IN_DAEMON_ENV, raising=False)
    rc = main(["info", "/nonexistent/model/path.model"])
    assert rc == 1                     # the daemon caught the error
    assert "FileNotFoundError" in capsys.readouterr().err


def test_client_forwards_stdin(server, small_corpus_file, tmp_path,
                               monkeypatch, capsys):
    """encode with its default --input - sends the client's stdin."""
    model = str(tmp_path / "s.model")
    assert main(["train", "--corpus", small_corpus_file, "--model", model,
                 "--vocab-size", "280", "--min-pair-freq", "2",
                 "--device", "cpu"]) == 0
    capsys.readouterr()
    argv = ["encode", "--model", model, "--device", "cpu"]
    monkeypatch.setattr(sys, "stdin", io.StringIO(TEXT))
    assert daemon.run_client(argv, socket_path=server,
                             auto_start=False) == 0
    via_daemon = capsys.readouterr().out
    monkeypatch.setattr(sys, "stdin", io.StringIO(TEXT))
    assert main(argv) == 0
    assert via_daemon == capsys.readouterr().out and len(via_daemon) > 10


def test_names_differ_from_the_jax_daemon(monkeypatch):
    for env in (daemon.SOCKET_ENV, "SHREDWORD_DAEMON_SOCKET"):
        monkeypatch.delenv(env, raising=False)
    assert daemon.default_socket_path() != jax_daemon.default_socket_path()
    names = {daemon.ROUTE_ENV, daemon.SOCKET_ENV, daemon.IN_DAEMON_ENV}
    assert not names & {"SHREDWORD_DAEMON", "SHREDWORD_DAEMON_SOCKET",
                        "_SHREDWORD_IN_DAEMON"}
    monkeypatch.setenv("SHREDWORD_DAEMON_SOCKET", "/x/jax.sock")
    assert daemon.default_socket_path() != "/x/jax.sock"


def test_port_client_ignores_the_jax_routing(server, tmp_path, monkeypatch):
    """The JAX package's routing variables pointed at a live port server
    route nothing: the command runs locally (its exception surfaces)."""
    monkeypatch.setenv("SHREDWORD_DAEMON", "1")
    monkeypatch.setenv("SHREDWORD_DAEMON_SOCKET", server)
    monkeypatch.delenv("_SHREDWORD_IN_DAEMON", raising=False)
    monkeypatch.delenv(daemon.ROUTE_ENV, raising=False)
    with pytest.raises(FileNotFoundError):
        main(["info", str(tmp_path / "missing.model")])


def test_jax_client_ignores_the_port_routing(server, tmp_path, monkeypatch):
    monkeypatch.setenv(daemon.ROUTE_ENV, "1")
    monkeypatch.setenv(daemon.SOCKET_ENV, server)
    monkeypatch.delenv("SHREDWORD_DAEMON", raising=False)
    monkeypatch.delenv("SHREDWORD_DAEMON_SOCKET", raising=False)
    with pytest.raises(FileNotFoundError):
        jax_cli.main(["info", str(tmp_path / "missing.model")])


# ---------------------------------------------------------------------
# the JAX daemon's faults, fixed
# ---------------------------------------------------------------------

def test_string_system_exit_is_rc_1(monkeypatch):
    """A SystemExit with a message gives rc 1 and the message on stderr;
    the handler returns (the JAX daemon's int(e.code) raised out of the
    serve loop)."""
    def exits(argv):
        raise SystemExit("bad input: boom")

    monkeypatch.setattr(cli, "main", exits)
    r = daemon._handle({"argv": ["info", "x"]})
    assert r["rc"] == 1 and "bad input: boom" in r["stderr"]
    assert [daemon.exit_code(c) for c in (None, 0, 3)] == [0, 0, 3]


def test_socket_is_private_from_bind(tmp_path, monkeypatch):
    """The socket file is 0600 the moment bind creates it (umask 0o177
    around bind; the JAX daemon chmods after bind), and the process's
    umask is restored."""
    sock = str(tmp_path / "u.sock")
    seen = {}
    real_bind = socket.socket.bind

    def spy(self, addr):
        real_bind(self, addr)
        seen["mode"] = stat.S_IMODE(os.stat(addr).st_mode)

    monkeypatch.setattr(socket.socket, "bind", spy)
    monkeypatch.setenv(daemon.IN_DAEMON_ENV, "0")
    old = os.umask(0o022)
    try:
        assert daemon.serve(sock, idle_timeout=0.3) == 0
        assert os.umask(0o022) == 0o022
    finally:
        os.umask(old)
    assert seen["mode"] == 0o600


def test_lock_file_is_never_unlinked(tmp_path):
    """A server that waits on the lock file while the owner exits must
    contend with the next server for the same file: the JAX daemon
    unlinked it on exit, so the waiter and a new server each locked a
    different file."""
    sock = str(tmp_path / "l.sock")
    first = _spawn(sock, str(tmp_path / "a.log"))
    waiter = os.open(sock + ".lock", os.O_RDWR)
    try:
        _stop(sock, first)
        assert os.path.exists(sock + ".lock")
        second = _spawn(sock, str(tmp_path / "b.log"))
        try:
            with pytest.raises(BlockingIOError):
                fcntl.flock(waiter, fcntl.LOCK_EX | fcntl.LOCK_NB)
        finally:
            _stop(sock, second)
        fcntl.flock(waiter, fcntl.LOCK_EX | fcntl.LOCK_NB)
    finally:
        os.close(waiter)


def test_stop_on_a_busy_server_is_not_not_running(tmp_path):
    """A server busy with a command is reported "busy" (the JAX daemon
    said "no daemon running"), and exits when that command ends."""
    sock = str(tmp_path / "b.sock")
    proc = _spawn(sock, str(tmp_path / "b.log"))
    hold = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        hold.connect(sock)       # an unfinished request keeps it busy
        assert daemon.stop_state(sock, timeout=1.0) == "busy"
        assert proc.poll() is None and daemon.alive(sock)
    finally:
        hold.close()
    assert proc.wait(timeout=60) == 0
    assert daemon.stop_state(sock) == "not running"
    assert _cli_out(["daemon", "stop", "--socket", sock]) == \
        (1, "no daemon running\n")
    assert _cli_out(["daemon", "status", "--socket", sock]) == \
        (1, "no daemon running\n")


def test_stop_returns_a_bool_as_the_jax_package(tmp_path):
    """stop() answers True once the daemon has stopped and False when
    none runs, as the JAX package's stop() does; the CLI prints the
    three-way stop_state()."""
    sock = str(tmp_path / "s.sock")
    proc = _spawn(sock, str(tmp_path / "s.log"))
    assert daemon.stop(sock) is True
    assert proc.wait(timeout=60) == 0
    assert daemon.stop(sock) is False
    assert jax_daemon.stop(sock) is False
    assert _cli_out(["daemon", "stop", "--socket", sock]) == \
        (1, "no daemon running\n")


def _cli_out(argv) -> tuple[int, str]:
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()
