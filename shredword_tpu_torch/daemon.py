"""Warm-process daemon for the CLI: one server process runs the commands
of thin clients, so a command skips the process's start-up (the import
of torch, the load of the host and kernel libraries, the CUDA context).

The JAX package's daemon (``shredword_tpu/daemon.py``) with the same
protocol and lifecycle, and its own socket and environment variables,
so that a client of one package never reaches the other's server:

  SHREDWORD_TORCH_DAEMON=1           route every CLI command through it
  SHREDWORD_TORCH_DAEMON_SOCKET      the socket (default: per uid in the
                                     temporary directory)

Protocol (newline-delimited JSON over a unix socket):

  request  {"argv": [...], "stdin": str, "cwd": str}
  response {"rc": int, "stdout": str, "stderr": str}

Special argv values: ``["__ping__"]`` health check, ``["__stop__"]``
clean shutdown.  The server is single-threaded by design: commands
serialize on the one card anyway, and per-request ``os.chdir`` stays
race-free.  A busy server still accepts connections into its listen
backlog, so liveness is a connect probe (``alive``), and a client simply
waits its turn.

Usage:

  python -m shredword_tpu_torch daemon start|stop|status
  SHREDWORD_TORCH_DAEMON=1 python -m shredword_tpu_torch train ...

The server exits after ``--idle-timeout`` seconds (default 1 h) without
a request.  Warm-up loads the host library and, where a card exists, the
kernel library and the CUDA context; it never changes where a command
runs: a command fails or succeeds as it would in a fresh process.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

ROUTE_ENV = "SHREDWORD_TORCH_DAEMON"
SOCKET_ENV = "SHREDWORD_TORCH_DAEMON_SOCKET"
IN_DAEMON_ENV = "_SHREDWORD_TORCH_IN_DAEMON"
_MAX_LINE = 512 * 2**20     # refuse absurd requests (corrupt stream)


def default_socket_path() -> str:
    return os.environ.get(
        SOCKET_ENV,
        os.path.join(tempfile.gettempdir(),
                     f"shredword_torch_daemon_{os.getuid()}.sock"))


# ---------------------------------------------------------------------------
# server


def exit_code(code) -> int:
    """The process exit code of ``SystemExit(code)``, as the interpreter
    gives it: None is 0, an int is itself, anything else (a message) is
    printed to stderr and is 1."""
    if code is None:
        return 0
    if isinstance(code, int):
        return code
    print(code, file=sys.stderr)
    return 1


def _handle(req: dict) -> dict:
    """Run one CLI command in-process with captured stdio."""
    argv = req.get("argv", [])
    out, err = io.StringIO(), io.StringIO()
    rc = 0
    old_cwd = os.getcwd()
    old_stdin = sys.stdin
    try:
        cwd = req.get("cwd")
        if cwd:
            os.chdir(cwd)
        sys.stdin = io.StringIO(req.get("stdin", ""))
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            from . import cli
            try:
                rc = cli.main(argv)
            except SystemExit as e:      # argparse errors exit
                rc = exit_code(e.code)
            except Exception:            # command failed; daemon lives on
                import traceback
                traceback.print_exc()
                rc = 1
    finally:
        sys.stdin = old_stdin
        os.chdir(old_cwd)
    return {"rc": rc, "stdout": out.getvalue(), "stderr": err.getvalue()}


def _recv_line(conn: socket.socket) -> bytes | None:
    chunks = []
    total = 0
    while True:
        b = conn.recv(1 << 20)
        if not b:
            return None
        chunks.append(b)
        total += len(b)
        if b.endswith(b"\n"):
            return b"".join(chunks)
        if total > _MAX_LINE:
            return None


def _bind_private(srv: socket.socket, path: str) -> None:
    """Bind ``srv`` to ``path`` with the socket file created 0600: under
    umask 0o177, so it is never open to others, not even briefly."""
    old = os.umask(0o177)
    try:
        srv.bind(path)
    finally:
        os.umask(old)


def _warm_up() -> None:
    """Load what every command would load first in a fresh process."""
    import torch

    from .runtime import native
    native.lib()
    if torch.cuda.is_available():
        from .ops import _kernels
        _kernels.lib()
        torch.cuda.init()


def serve(socket_path: str | None = None,
          idle_timeout: float = 3600.0) -> int:
    """Run the daemon loop (blocks).  Returns process exit code."""
    # The server must never route its own command handling back through
    # daemon clients: with the routing variable inherited from the
    # spawning client, cli.main inside _handle would try to reach the
    # daemon (busy: itself), fail, and auto-start another server.
    os.environ[IN_DAEMON_ENV] = "1"
    path = socket_path or default_socket_path()
    # Exclusive lock: a second `serve` on the same path must exit, not
    # steal the socket from a live (possibly busy) server.  The lock file
    # is never unlinked: a server that unlinked it on exit would let a
    # waiting server lock the old file while a new one locks a new file.
    import fcntl
    lock_fd = os.open(path + ".lock", os.O_CREAT | os.O_RDWR, 0o600)
    try:
        fcntl.flock(lock_fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
    except OSError:
        os.close(lock_fd)
        print(f"[daemon] another server owns {path}; exiting",
              flush=True)
        return 1
    try:
        with contextlib.suppress(FileNotFoundError):
            os.unlink(path)      # stale socket only: the lock is ours
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            _bind_private(srv, path)
            srv.listen(16)       # busy-server clients queue here
            srv.settimeout(idle_timeout)
            _warm_up()
            print(f"[daemon] serving on {path} (pid {os.getpid()})",
                  flush=True)
            return _loop(srv)
        finally:
            srv.close()
            with contextlib.suppress(FileNotFoundError):
                os.unlink(path)
    finally:
        os.close(lock_fd)        # releases the flock


def _loop(srv: socket.socket) -> int:
    while True:
        try:
            conn, _ = srv.accept()
        except socket.timeout:
            print("[daemon] idle timeout, exiting", flush=True)
            return 0
        with conn:
            line = _recv_line(conn)
            if not line:
                continue
            try:
                req = json.loads(line)
            except ValueError:
                continue
            argv = req.get("argv", [])
            if argv == ["__ping__"]:
                resp = {"rc": 0, "stdout": "pong\n", "stderr": ""}
            elif argv == ["__stop__"]:
                with contextlib.suppress(BrokenPipeError,
                                         ConnectionResetError):
                    conn.sendall(json.dumps(
                        {"rc": 0, "stdout": "stopping\n",
                         "stderr": ""}).encode() + b"\n")
                return 0
            else:
                resp = _handle(req)
            with contextlib.suppress(BrokenPipeError,
                                     ConnectionResetError):
                conn.sendall(json.dumps(resp).encode() + b"\n")


# ---------------------------------------------------------------------------
# client


class _Timeout(Exception):
    """The server accepted the request but did not answer in time."""


def _request(argv: list[str], path: str, stdin_text: str,
             timeout: float | None) -> dict | None:
    """One request; None if the server is not reachable, _Timeout if it
    took the request but did not answer within ``timeout`` seconds."""
    try:
        c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        c.settimeout(timeout)
        c.connect(path)
    except OSError:
        return None
    try:
        req = {"argv": argv, "stdin": stdin_text, "cwd": os.getcwd()}
        c.sendall(json.dumps(req).encode() + b"\n")
        line = _recv_line(c)
        if not line:
            return None
        return json.loads(line)
    except socket.timeout:
        raise _Timeout from None
    except (OSError, ValueError):
        return None
    finally:
        c.close()


def request(argv: list[str], *, socket_path: str | None = None,
            stdin_text: str = "", timeout: float = 24 * 3600.0,
            ) -> dict | None:
    """Send one command to the daemon; None if it is not reachable or
    did not answer within ``timeout`` seconds."""
    path = socket_path or default_socket_path()
    try:
        return _request(argv, path, stdin_text, timeout)
    except _Timeout:
        return None


def ping(socket_path: str | None = None) -> bool:
    r = request(["__ping__"], socket_path=socket_path, timeout=10.0)
    return bool(r) and r.get("stdout") == "pong\n"


def alive(socket_path: str | None = None) -> bool:
    """Connect-level liveness: a listening server accepts the connect
    into its backlog even while busy running a long command, so this,
    unlike ping(), never mistakes a busy daemon for a dead one."""
    path = socket_path or default_socket_path()
    try:
        c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        c.settimeout(5.0)
        c.connect(path)
        c.close()
        return True
    except OSError:
        return False


def start(socket_path: str | None = None, *, wait: float = 60.0,
          idle_timeout: float = 3600.0) -> bool:
    """Spawn a detached daemon process; True once it is reachable."""
    path = socket_path or default_socket_path()
    if alive(path):
        return True
    log_path = path + ".log"
    with open(log_path, "ab") as log:
        subprocess.Popen(
            [sys.executable, "-m", "shredword_tpu_torch", "daemon", "serve",
             "--socket", path, "--idle-timeout", str(idle_timeout)],
            stdout=log, stderr=log, stdin=subprocess.DEVNULL,
            start_new_session=True)
    deadline = time.monotonic() + wait
    while time.monotonic() < deadline:
        if alive(path):
            return True
        time.sleep(0.2)
    return False


def stop(socket_path: str | None = None, timeout: float = 10.0) -> str:
    """Ask the daemon to exit: "stopped" once it has answered,
    "not running" when nothing listens on the socket, "busy" when it
    took the request but is still running a command after ``timeout``
    seconds (it exits when that command ends)."""
    path = socket_path or default_socket_path()
    if not alive(path):
        return "not running"
    try:
        r = _request(["__stop__"], path, "", timeout)
    except _Timeout:
        return "busy"
    return "stopped" if r is not None else "not running"


def _reads_stdin(argv: list[str]) -> bool:
    """Whether the command reads standard input: encode and decode with
    ``--input -``, their default."""
    inp = "-"
    for i, a in enumerate(argv):
        if a == "--input" and i + 1 < len(argv):
            inp = argv[i + 1]
        elif a.startswith("--input="):
            inp = a[len("--input="):]
    return argv[:1] in (["encode"], ["decode"]) and inp == "-"


def run_client(argv: list[str], *, socket_path: str | None = None,
               auto_start: bool = True) -> int | None:
    """Route a CLI command through the daemon.  Returns the command's
    exit code, or None if no daemon could be reached or started (the
    caller runs the command locally)."""
    path = socket_path or default_socket_path()
    if not alive(path) and not (auto_start and start(path)):
        return None
    stdin_text = ""
    if _reads_stdin(argv) and not sys.stdin.isatty():
        stdin_text = sys.stdin.read()
    r = request(argv, socket_path=path, stdin_text=stdin_text)
    if r is None:
        return None
    sys.stdout.write(r.get("stdout", ""))
    sys.stderr.write(r.get("stderr", ""))
    return int(r.get("rc", 1))
