"""The port's unix-socket transport, stream resume, text prompts and
client against the JAX package's, on the same tiny fp32 Llama.

Both packages' servers run `serve_socket` in-process (the engine loop
on a thread of its own), and both packages' clients talk to both. For
every request every record is compared: the stream index `i`, the
event, the id, the token and its text. Temperature-0 and text-prompt
streams are equal across the packages. A seeded sampled stream cannot
be: torch cannot draw JAX's threefry bits, so the port seeds each draw
by (seed, position) on its own generator. Its records keep the
reference's shape (ids, indices, events), and its tokens equal an
uninterrupted in-process port engine's. A resume with `next_index` k
delivers exactly the tail.
"""

from __future__ import annotations

import functools
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
from flax import traverse_util

from hyperion_tpu.data import bpe as jbpe
from hyperion_tpu.models import llama as jl
from hyperion_tpu.serve import client as jclient
from hyperion_tpu.serve import server as jserver
from hyperion_tpu_torch.data import bpe as tbpe
from hyperion_tpu_torch.models import llama as tl
from hyperion_tpu_torch.serve import client as tclient
from hyperion_tpu_torch.serve import server as tserver
from hyperion_tpu_torch.serve.engine import Engine, EngineConfig
from hyperion_tpu_torch.serve.queue import Request

REPO = Path(__file__).resolve().parents[1]
VOCAB = 512
CLIENTS = {"jax": jclient, "port": tclient}


@functools.cache
def host_pair():
    """(JAX model, JAX variables, port model): a tiny fp32 Llama with a
    512-token vocabulary, so a trained tokenizer's ids fit it. Built once
    a process; the router and load-generator tests share it."""
    jmodel = jl.Llama(jl.llama_tiny_config(max_len=64, vocab_size=VOCAB))
    params = jax.device_get(jmodel.init_params(jax.random.key(3), seq=8))
    cfg = tl.llama_tiny_config(max_len=64, vocab_size=VOCAB)
    model = tl.Llama(cfg, device="cpu")
    model.load_state_dict(tl.params_from_jax(params, cfg))
    return jmodel, {"params": params}, model


def export_npz(path: Path) -> Path:
    flat = traverse_util.flatten_dict(host_pair()[1]["params"], sep="/")
    np.savez(path, **{k: np.asarray(v) for k, v in flat.items()})
    return path


def tokenizer_lines() -> list[str]:
    rng = np.random.default_rng(5)
    words = ["the", "model", "serves", "tokens", "it's", "over", "a",
             "socket", "and", "resumes", "streams", "café", "12"]
    return [" ".join(words[int(i)] for i in rng.integers(0, len(words), 9))
            for _ in range(200)]


def save_tokenizer(path: Path) -> Path:
    """The port's tokenizer, 150 merges: ids stay below VOCAB."""
    tbpe.train_bpe(tokenizer_lines(), vocab_size=256 + 1 + 150).save(path)
    return path


def normalize(recs: list[dict]) -> list[dict]:
    """The wire records less the server-side TTFT clock."""
    return [{k: v for k, v in r.items() if k != "ttft_ms"} for r in recs]


REQUESTS = {
    "greedy": {"id": "g", "prompt_ids": [5, 17, 33, 2, 9, 41, 7, 12],
               "max_new_tokens": 8},
    "sampled": {"id": "s", "prompt_ids": [8, 3, 99, 14, 6],
                "max_new_tokens": 8, "temperature": 0.8, "top_p": 0.9,
                "seed": 11},
    "text": {"id": "t", "prompt": "the model serves tokens over a socket",
             "max_new_tokens": 6},
}


class _Server:
    """One package's `serve_socket` on a thread, engine loop included."""

    def __init__(self, pkg: str, sock: str, tok_dir: Path):
        jmodel, variables, model = host_pair()
        if pkg == "jax":
            from hyperion_tpu.serve.engine import Engine as JEngine
            from hyperion_tpu.serve.engine import EngineConfig as JConfig

            self.engine = JEngine(jmodel, variables,
                                  JConfig(slots=2, max_len=64, eos_id=None))
            tok, mod = jbpe.ByteBPE.load(tok_dir), jserver
        else:
            self.engine = Engine(model, EngineConfig(slots=2, max_len=64,
                                                     eos_id=None),
                                 device="cpu")
            tok, mod = tbpe.ByteBPE.load(tok_dir), tserver
        self.engine.warmup([16])
        self.sock = sock
        self._stop = threading.Event()
        ready = threading.Event()
        self._t = threading.Thread(
            target=mod.serve_socket, args=(self.engine, sock, tok),
            kwargs={"should_stop": self._stop.is_set, "ready": ready},
            daemon=True)
        self._t.start()
        assert ready.wait(timeout=30)

    def close(self) -> None:
        self._stop.set()
        self._t.join(timeout=30)
        assert not self._t.is_alive()


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    d = tmp_path_factory.mktemp("sock")
    tok_dir = save_tokenizer(d / "tok")
    srv = {pkg: _Server(pkg, str(d / f"{pkg}.sock"), tok_dir)
           for pkg in ("jax", "port")}
    yield srv
    for s in srv.values():
        s.close()


_RUNS: dict = {}


def run(servers, client_pkg: str, server_pkg: str, name: str) -> list[dict]:
    key = (client_pkg, server_pkg, name)
    if key not in _RUNS:
        cli = CLIENTS[client_pkg].ServeClient
        with cli(servers[server_pkg].sock, timeout_s=60) as c:
            _RUNS[key] = normalize(list(c.stream(**REQUESTS[name])))
    return _RUNS[key]


def _shape(recs):
    return [(r["id"], r["event"], r.get("i"), r.get("n_tokens"))
            for r in recs]


def port_engine_stream(doc: dict) -> list[int]:
    eng = Engine(host_pair()[2], EngineConfig(slots=2, max_len=64,
                                              eos_id=None), device="cpu")
    req = Request(prompt_ids=np.asarray(doc["prompt_ids"], np.int32),
                  max_new_tokens=doc["max_new_tokens"],
                  temperature=doc.get("temperature", 0.0),
                  top_p=doc.get("top_p", 1.0), seed=doc.get("seed", 0))
    eng.submit(req)
    while not eng.idle:
        eng.step()
    return list(req.tokens)


@pytest.mark.parametrize("name", sorted(REQUESTS))
@pytest.mark.parametrize("client_pkg,server_pkg",
                         [("jax", "port"), ("port", "jax"),
                          ("port", "port")])
def test_wire_records_equal_across_packages(servers, client_pkg,
                                            server_pkg, name):
    recs = run(servers, client_pkg, server_pkg, name)
    ref = run(servers, "jax", "jax", name)
    assert recs[-1]["event"] == "done"
    n = REQUESTS[name]["max_new_tokens"]
    assert [r["i"] for r in recs if r["event"] == "token"] == list(range(n))
    # the client never alters a record: each server's stream is the same
    # through either package's client
    assert recs == run(servers, "jax", server_pkg, name)
    if name == "sampled":
        assert _shape(recs) == _shape(ref)
        if server_pkg == "port":
            toks = [r["token"] for r in recs if r["event"] == "token"]
            assert toks == port_engine_stream(REQUESTS[name])
    else:
        assert recs == ref


@pytest.mark.parametrize("server_pkg", ["jax", "port"])
@pytest.mark.parametrize("k", [0, 3, 8])
def test_resume_delivers_exactly_the_tail(servers, server_pkg, k):
    full = run(servers, "jax", server_pkg, "greedy")
    doc = REQUESTS["greedy"]
    with tclient.ServeClient(servers[server_pkg].sock, timeout_s=60) as c:
        got = normalize(list(c.stream(kind="resume", request_id=doc["id"],
                                      next_index=k, request=doc,
                                      id=doc["id"])))
    tail = [r for r in full if r["event"] != "token" or r["i"] >= k]
    assert got == tail


@pytest.mark.parametrize("server_pkg", ["jax", "port"])
def test_resume_without_the_request_is_rejected(servers, server_pkg):
    with tclient.ServeClient(servers[server_pkg].sock, timeout_s=60) as c:
        got = list(c.stream(kind="resume", request_id="nope",
                            next_index=2, id="nope"))
    assert got == [{"id": "nope", "event": "rejected",
                    "reason": "unknown_request"}]


# ------------------------------------------------ the parser, both sides

LINES = {
    "bad_json": "{nope",
    "not_object": "[1, 2]",
    "no_prompt": '{"id": "x"}',
    "text_without_tokenizer": '{"id": "x", "prompt": "hi"}',
    "bad_field": '{"id": "x", "prompt_ids": [1], "max_new_tokens": "many"}',
    "ids": '{"id": "x", "prompt_ids": [4, 5], "top_k": 3, "class": "batch",'
           ' "tenant": "t1", "future_key": 1}',
}


@pytest.mark.parametrize("name", sorted(LINES))
def test_request_lines_parse_as_the_reference_does(name):
    ref = jserver.parse_request_line(LINES[name], None)
    got = tserver.parse_request_line(LINES[name], None)
    if isinstance(ref, dict):
        assert got == ref
    else:
        fields = ("id", "max_new_tokens", "temperature", "top_k", "top_p",
                  "seed", "deadline_s", "sla_class", "tenant")
        assert [getattr(got, f) for f in fields] \
            == [getattr(ref, f) for f in fields]
        assert got.prompt_ids.tolist() == np.asarray(ref.prompt_ids).tolist()


EVENTS = {
    "token": dict(token=17, finished=False),
    "last_token": dict(token=17, finished=True),
    "recovered_done": dict(token=None, finished=True, kind="done"),
    "rejected": dict(token=None, finished=True, kind="rejected",
                     reason="queue_full"),
}


@pytest.mark.parametrize("with_tok", [False, True])
@pytest.mark.parametrize("name", sorted(EVENTS))
def test_event_records_equal_the_reference(tmp_path, name, with_tok):
    from hyperion_tpu.serve import engine as jengine
    from hyperion_tpu.serve import queue as jqueue
    from hyperion_tpu_torch.serve import engine as tengine

    tok_dir = save_tokenizer(tmp_path / "tok") if with_tok else None
    recs = []
    for qmod, emod, bmod, smod in ((jqueue, jengine, jbpe, jserver),
                                   (sys.modules[Request.__module__],
                                    tengine, tbpe, tserver)):
        req = qmod.Request(prompt_ids=[3, 4], max_new_tokens=2, id="r1")
        req.tokens = [9, 17]
        req.submitted_at, req.first_token_at = 1.0, 1.25
        tok = bmod.ByteBPE.load(tok_dir) if with_tok else None
        recs.append(smod.event_record(emod.TokenEvent(req, **EVENTS[name]),
                                      tok))
    assert recs[1] == recs[0]


@pytest.mark.parametrize("line", ['{"kind": "resume", "request_id": "r"}',
                                  '{"id": "resume"}', '{"kind": "resume"',
                                  '{"prompt_ids": [1]}'])
def test_resume_verb_detection_matches(line):
    assert tserver.maybe_resume_doc(line) == jserver.maybe_resume_doc(line)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_client_raises_stream_interrupted_on_a_cut(tmp_path, pkg):
    path = str(tmp_path / "cut.sock")
    _cutting_server(path, cut_at=2)
    mod = CLIENTS[pkg]
    got = []
    with pytest.raises(mod.StreamInterrupted) as ei:
        with mod.ServeClient(path, timeout_s=5.0) as c:
            for rec in c.stream(id="r1", prompt_ids=[1], max_new_tokens=6):
                got.append(rec)
    assert [r["token"] for r in got] == [100, 101]
    assert (ei.value.request_id, ei.value.next_index) == ("r1", 2)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_client_resume_turns_a_cut_into_one_stream(tmp_path, pkg):
    path = str(tmp_path / "res.sock")
    _cutting_server(path, cut_at=2, n=6)
    with CLIENTS[pkg].ServeClient(path, timeout_s=5.0, resume=True) as c:
        recs = list(c.stream(id="r2", prompt_ids=[1], max_new_tokens=6))
    toks = [r for r in recs if r.get("event") == "token"]
    assert [r["i"] for r in toks] == list(range(6))
    assert [r["token"] for r in toks] == [100 + i for i in range(6)]
    assert recs[-1]["event"] == "done"
    assert tclient.TERMINAL_EVENTS == jclient.TERMINAL_EVENTS


def _cutting_server(path, cut_at=2, n=6):
    """A wire server whose first connection dies after `cut_at` tokens;
    a reconnect that speaks the resume verb gets the rest."""

    def serve():
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        srv.bind(path)
        srv.listen(2)
        for life in range(2):
            conn, _ = srv.accept()
            doc = json.loads(conn.makefile("rb").readline())
            if doc.get("kind") == "resume":
                rid, start = doc["request_id"], int(doc["next_index"])
            else:
                rid, start = doc["id"], 0
            for i in range(start, cut_at if life == 0 else n):
                conn.sendall((json.dumps({"id": rid, "event": "token",
                                          "token": 100 + i, "i": i})
                              + "\n").encode())
            if life == 1:
                conn.sendall((json.dumps({"id": rid, "event": "done",
                                          "n_tokens": n}) + "\n").encode())
            conn.close()
        srv.close()

    threading.Thread(target=serve, daemon=True).start()


# --------------------------------------------- the CLI, as a subprocess


def test_cli_serves_text_on_a_socket_and_drains(tmp_path):
    """`python -m hyperion_tpu_torch.cli.main serve --socket` with a
    tokenizer: a text prompt streams back with its text, the greedy
    tokens equal the in-process JAX server's, and SIGTERM drains to
    exit 0."""
    ckpt = export_npz(tmp_path / "tiny.npz")
    tok_dir = save_tokenizer(tmp_path / "tok")
    sock = str(tmp_path / "cli.sock")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("HYPERION_TELEMETRY", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "hyperion_tpu_torch.cli.main", "serve",
         "--ckpt", str(ckpt), "--tokenizer-dir", str(tok_dir),
         "--device", "cpu", "--dtype", "float32", "--max-len", "64",
         "--slots", "2", "--warmup-lens", "16", "--socket", sock],
        env=env, cwd=tmp_path, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        t0 = time.monotonic()
        while not os.path.exists(sock):
            assert proc.poll() is None, proc.communicate(timeout=10)[1]
            assert time.monotonic() - t0 < 60
            time.sleep(0.1)
        with tclient.ServeClient(sock, timeout_s=60) as c:
            recs = list(c.stream(**REQUESTS["text"]))
            greedy = list(c.stream(**REQUESTS["greedy"]))
        tok = tbpe.ByteBPE.load(tok_dir)
        toks = [r["token"] for r in recs if r["event"] == "token"]
        assert recs[-1]["event"] == "done"
        assert recs[-1]["text"] == tok.decode(toks)
        assert all("text" in r for r in recs if r["event"] == "token")
        ref = jserver.parse_request_line(json.dumps(REQUESTS["greedy"]))
        assert [r["token"] for r in greedy if r["event"] == "token"] \
            == _jax_generate(ref.prompt_ids, 8)
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err[-2000:]
        assert not os.path.exists(sock)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=10)


def _jax_generate(prompt, n) -> list[int]:
    import jax.numpy as jnp

    from hyperion_tpu.infer.generate import generate

    jmodel, variables, _ = host_pair()
    return np.asarray(generate(jmodel, variables,
                               jnp.asarray(prompt)[None], n))[0].tolist()
