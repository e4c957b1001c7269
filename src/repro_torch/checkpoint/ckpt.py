"""Checkpointing (port of ``repro.checkpoint.ckpt``): npz-based tree
save/restore with path-flattened keys, plus BLOCK-WISE checkpoints — each
DiffusionBlocks block saves/restores its unit slice independently, which is
what block-parallel training needs (each block writes only its slice; a merge
step assembles the full model).

The on-disk layout is the JAX package's, so a file written by either package
loads in the other: one npz per tree, keyed by the ``"/".join`` of the tree
path (a dict key as itself, a list index as its number, a NamedTuple field as
``.name``: ``AdamWState`` flattens to ``.step``, ``.mu/...``, ``.nu/...``);
bf16 leaves are widened to fp32 in the file and cast back to the template's
dtype on load; metadata in a ``.meta.json`` sidecar; ``block_NN.npz``,
``block_NN.opt.npz`` and ``periphery.opt.npz`` for the flat per-block
layout; ``gen_NNNNNN/`` and ``MANIFEST-NNNNNN.json`` with a sha256 per file
for the managed generations.

Trees here are nested dicts of tensors (and ``AdamWState``s). A save moves
each leaf to the host once (one device-to-host copy per leaf); a load makes
each leaf in its template's dtype, on its template's device or on the one
asked for (the trainers load on the host and copy into their live state).

Crash consistency
-----------------
Every write in this module is ATOMIC: the payload goes to a temp file in the
destination directory, is fsync'd, and only then renamed over the final path
(``os.replace`` — atomic on POSIX). A crash mid-save therefore never leaves a
truncated ``.npz`` under the real name; readers see either the old complete
file or the new complete file. A file that is nonetheless unreadable (torn by
a pre-atomic writer, bit rot, truncation by an injected ``ckpt_corrupt``
fault) raises ``CheckpointCorrupt`` with the offending path — never a raw
zipfile/KeyError traceback.

On top of the atomic primitives, ``CheckpointManager`` provides VERSIONED
GENERATIONS for fault-tolerant training (``repro_torch.launch.trainrunner``):
each save writes a fresh ``gen_NNNNNN/`` directory of npz files, then
atomically publishes ``MANIFEST-NNNNNN.json`` carrying the training step, rng
state, data-loader cursor, guard counters, and a sha256 per file.
``load_latest`` verifies every checksum and falls back to the previous
generation when any file of the newest one is corrupt — a torn or rotted
checkpoint is DETECTED, not silently loaded.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch


class CheckpointError(RuntimeError):
    """Base class for checkpoint failures."""


class CheckpointCorrupt(CheckpointError):
    """A checkpoint file exists but cannot be read back (truncated archive,
    missing key, checksum mismatch). The message names the file and the
    remedy: delete it (flat layout) or let the manifest loader fall back to
    the previous generation (managed layout)."""


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _items(tree, path: Tuple[str, ...] = ()
           ) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) pairs in the JAX package's flattening order and naming."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], path + (str(k),))
    elif _is_namedtuple(tree):
        for f in tree._fields:
            yield from _items(getattr(tree, f), path + ("." + f,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _items(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def _rebuild(tree, fn: Callable[[str, Any], Any],
             path: Tuple[str, ...] = ()):
    """``tree`` with every leaf replaced by ``fn(key, leaf)``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, path + (str(k),)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(getattr(tree, f), fn, path + ("." + f,))
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, fn, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def _host(leaf: torch.Tensor) -> np.ndarray:
    t = leaf.detach().to("cpu")               # the one device-to-host copy
    if t.dtype == torch.bfloat16:             # npz has no bf16; widen
        t = t.float()                         # (load casts back)
    return t.numpy()


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {k: _host(leaf) for k, leaf in _items(tree)}


def _atomic_write(path: str, write_fn: Callable[[Any], None],
                  mode: str = "wb") -> None:
    """Write via temp-file + fsync + rename so ``path`` is never torn."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".tmp")
    try:
        with os.fdopen(fd, mode) as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def tree_digest(tree) -> str:
    """sha256 over every leaf's bytes (sorted by flattened key) — two trees
    share a digest iff they are BIT-identical; the same digest as the JAX
    package's for the same values."""
    h = hashlib.sha256()
    flat = _flatten(tree)
    for k in sorted(flat):
        arr = np.ascontiguousarray(flat[k])
        h.update(k.encode())
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def save_pytree(path: str, tree, metadata: Optional[dict] = None) -> None:
    if not path.endswith(".npz"):
        path = path + ".npz"
    flat = _flatten(tree)
    _atomic_write(path, lambda f: np.savez(f, **flat))
    if metadata is not None:
        meta = path[:-4] + ".meta.json"
        _atomic_write(meta, lambda f: f.write(json.dumps(metadata)), "w")


def load_pytree(path: str, template, device=None) -> Any:
    """The tree saved at ``path``, shaped like ``template``: each leaf in
    its template leaf's dtype, on ``device`` (default: the template leaf's
    device)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    try:
        data = np.load(path)
    except Exception as e:
        raise CheckpointCorrupt(
            f"checkpoint {path!r} is unreadable ({type(e).__name__}: {e}) — "
            f"likely a torn write from a crashed run; delete the file or "
            f"resume from an earlier manifest generation") from e

    def one(key, leaf):
        try:
            arr = data[key]
        except Exception as e:
            raise CheckpointCorrupt(
                f"checkpoint {path!r} is missing or cannot decode key "
                f"{key!r} ({type(e).__name__}) — the archive is incomplete; "
                f"delete the file or resume from an earlier manifest "
                f"generation") from e
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{path}: {key} has shape {arr.shape}, the "
                             f"template {tuple(leaf.shape)}")
        return torch.from_numpy(arr).to(
            device=leaf.device if device is None else device,
            dtype=leaf.dtype)

    with data:
        return _rebuild(template, one)


def load_metadata(path: str) -> Optional[dict]:
    meta = (path[:-4] if path.endswith(".npz") else path) + ".meta.json"
    if os.path.exists(meta):
        with open(meta) as f:
            return json.load(f)
    return None


def copy_into(dst, src) -> None:
    """Copy every leaf of ``src`` into the same leaf of ``dst`` in place
    (``dst``'s tensors keep their storage: stacked views stay views)."""
    got = dict(_items(src))
    with torch.no_grad():
        for key, leaf in _items(dst):
            leaf.copy_(got[key])


# ---------------------------------------------------------------------------
# Block-wise checkpoints (DiffusionBlocks)
# ---------------------------------------------------------------------------
STACK_KEYS = ("layers", "units")


def save_block(ckpt_dir: str, params, block: int, start: int, size: int,
               step: int = 0) -> str:
    """Save block ``block``'s unit slice + the shared periphery."""
    from repro_torch.core.training import extract_block_view
    return save_block_view(ckpt_dir, extract_block_view(params, start, size),
                           block, start, size, step)


def save_block_view(ckpt_dir: str, view, block: int, start: int, size: int,
                    step: int = 0) -> str:
    """Save a block's view (its ``size`` units + the periphery) as block
    ``block`` at units ``start`` (``save_block``'s file)."""
    path = os.path.join(ckpt_dir, f"block_{block:02d}.npz")
    save_pytree(path, view, {"block": block, "start": start, "size": size,
                             "step": step})
    return path


def save_block_opt(ckpt_dir: str, block: int, opt_state, step: int = 0) -> str:
    """Save one block's optimizer state (AdamW moments + step) — written by
    the block-parallel trainer so each block resumes independently."""
    path = os.path.join(ckpt_dir, f"block_{block:02d}.opt.npz")
    save_pytree(path, opt_state, {"block": block, "step": step})
    return path


def load_block_opt(ckpt_dir: str, block: int, template) -> Optional[Any]:
    """Restore one block's optimizer state; None when absent (fresh init)."""
    path = os.path.join(ckpt_dir, f"block_{block:02d}.opt.npz")
    if not os.path.exists(path):
        return None
    return load_pytree(path, template)


def load_blocks(ckpt_dir: str, params, ranges) -> Any:
    """Assemble a full model from per-block checkpoints, IN PLACE in
    ``params`` (shared periphery taken from the highest-numbered block
    present; blocks without a file keep their values). Returns ``params``."""
    from repro_torch.core.training import extract_block_view
    for b, (start, size) in enumerate(ranges):
        path = os.path.join(ckpt_dir, f"block_{b:02d}.npz")
        if not os.path.exists(path):
            continue
        view = extract_block_view(params, start, size)
        copy_into(view, load_pytree(path, view))
    return params


# ---------------------------------------------------------------------------
# Versioned manifest generations (fault-tolerant training)
# ---------------------------------------------------------------------------
MANIFEST_PREFIX = "MANIFEST-"
# a generation's files are written, hashed and read by this many threads:
# each file's copies, CRC, sha256 and I/O release the interpreter lock, so
# a save takes about as long as its largest file (the periphery's moments)
IO_THREADS = 8


def _each(fn, items):
    """[fn(*item)] over ``items``, IO_THREADS at a time (the first
    exception raised is re-raised)."""
    items = list(items)
    with ThreadPoolExecutor(max(1, min(IO_THREADS, len(items)))) as ex:
        return [f.result() for f in [ex.submit(fn, *it) for it in items]]


class CheckpointManager:
    """Generational checkpoints under one directory:

        ckpt_dir/
          gen_000001/<name>.npz ...     one npz per named tree
          MANIFEST-000001.json          published LAST (atomic rename)
          gen_000002/...
          MANIFEST-000002.json

    The manifest carries the caller's ``state`` payload (training step, rng,
    data cursor, guard counters, periphery policy — anything JSON) plus a
    sha256 per file. A generation is only visible once its manifest exists,
    and only loadable when every file passes its checksum, so a crash at ANY
    point of ``save`` (or corruption after it) degrades to "the previous
    generation loads" rather than "the run is poisoned".

    ``faults``: an optional ``repro_torch.launch.faults.FaultInjector``; the
    ``ckpt_corrupt`` hook (consulted once per save) truncates one freshly
    written file AFTER the manifest publish — the exact torn-write the
    checksum fallback exists to catch.

    A generation's files are written, hashed and read in parallel
    (``IO_THREADS``). ``timings`` records each save and each generation
    loaded: {"op", "generation", "bytes", "seconds", "sha256_s"} (host
    clock; a save's seconds include the copies to the host; ``sha256_s``
    is the checksums' wall, a save's summed over its threads).
    """

    def __init__(self, ckpt_dir: str, keep: int = 2, faults=None):
        if keep < 1:
            raise ValueError("keep must be >= 1")
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.faults = faults
        self.timings = []
        os.makedirs(ckpt_dir, exist_ok=True)

    # -- layout helpers -----------------------------------------------------
    def _manifest_path(self, gen: int) -> str:
        return os.path.join(self.ckpt_dir, f"{MANIFEST_PREFIX}{gen:06d}.json")

    def _gen_dir(self, gen: int) -> str:
        return os.path.join(self.ckpt_dir, f"gen_{gen:06d}")

    def generations(self):
        """Published generation numbers, ascending (manifest exists)."""
        out = []
        for name in os.listdir(self.ckpt_dir):
            if name.startswith(MANIFEST_PREFIX) and name.endswith(".json"):
                try:
                    out.append(int(name[len(MANIFEST_PREFIX):-5]))
                except ValueError:
                    continue
        return sorted(out)

    # -- save ---------------------------------------------------------------
    def save(self, trees: Dict[str, Any], state: dict) -> int:
        """Write one generation: every named tree, then the manifest.
        Returns the generation number."""
        t0 = time.perf_counter()
        gens = self.generations()
        gen = (gens[-1] + 1) if gens else 1
        gdir = self._gen_dir(gen)
        os.makedirs(gdir, exist_ok=True)

        def write(name, tree):
            path = os.path.join(gdir, f"{name}.npz")
            save_pytree(path, tree)
            t1 = time.perf_counter()
            digest = file_sha256(path)
            return (f"{name}.npz", digest, time.perf_counter() - t1,
                    os.path.getsize(path))

        done = _each(write, trees.items())
        files = {fname: digest for fname, digest, _, _ in done}
        sha_s = sum(d[2] for d in done)
        nbytes = sum(d[3] for d in done)
        manifest = {"generation": gen, "dir": os.path.basename(gdir),
                    "files": files, "state": state}
        _atomic_write(self._manifest_path(gen),
                      lambda f: f.write(json.dumps(manifest, indent=1)), "w")
        if self.faults is not None:
            # torn write: truncate one file of the generation we just
            # published — load_latest must detect it and fall back
            self.faults.maybe_corrupt(
                "ckpt_corrupt", os.path.join(gdir, sorted(files)[0]))
        self._prune(keep_at_least=gen)
        self.timings.append({"op": "save", "generation": gen,
                             "bytes": nbytes, "sha256_s": sha_s,
                             "seconds": time.perf_counter() - t0})
        return gen

    def _prune(self, keep_at_least: int) -> None:
        gens = self.generations()
        for g in gens[:-self.keep]:
            if g == keep_at_least:
                continue
            gdir = self._gen_dir(g)
            try:
                os.unlink(self._manifest_path(g))
                if os.path.isdir(gdir):
                    for f in os.listdir(gdir):
                        os.unlink(os.path.join(gdir, f))
                    os.rmdir(gdir)
            except OSError:
                pass                     # best-effort; never fail a save

    # -- load ---------------------------------------------------------------
    def verify(self, gen: int) -> bool:
        """All files of ``gen`` exist and match their manifest checksums."""
        try:
            with open(self._manifest_path(gen)) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            return False
        gdir = self._gen_dir(gen)

        def good(fname, digest):
            p = os.path.join(gdir, fname)
            return os.path.exists(p) and file_sha256(p) == digest

        return all(_each(good, manifest["files"].items()))

    def load_latest(self, templates: Dict[str, Any], log=None,
                    device=None) -> Tuple[Optional[Dict[str, Any]],
                                          Optional[dict]]:
        """Newest generation whose every file verifies → (trees, manifest);
        corrupt generations are skipped with a log line. (None, None) when
        nothing loadable exists. ``device`` as in ``load_pytree``: the
        trainers load on the host and copy into their live state."""
        for gen in reversed(self.generations()):
            t0 = time.perf_counter()
            if not self.verify(gen):
                if log:
                    log(f"[ckpt] generation {gen} failed checksum "
                        f"verification; falling back")
                continue
            sha_s = time.perf_counter() - t0
            with open(self._manifest_path(gen)) as f:
                manifest = json.load(f)
            gdir = self._gen_dir(gen)
            try:
                trees = dict(zip(templates, _each(
                    lambda name, tmpl: load_pytree(
                        os.path.join(gdir, f"{name}.npz"), tmpl, device),
                    templates.items())))
            except CheckpointCorrupt:
                if log:
                    log(f"[ckpt] generation {gen} unreadable despite "
                        f"checksum pass; falling back")
                continue
            self.timings.append({
                "op": "load", "generation": gen, "sha256_s": sha_s,
                "bytes": sum(os.path.getsize(os.path.join(gdir, f))
                             for f in manifest["files"]),
                "seconds": time.perf_counter() - t0})
            return trees, manifest
        return None, None

    def load_tree(self, gen: int, name: str, template, device=None) -> Any:
        """One named tree from one generation (per-block rewind)."""
        return load_pytree(os.path.join(self._gen_dir(gen), f"{name}.npz"),
                           template, device)

    def latest_good_generation(self) -> Optional[int]:
        for gen in reversed(self.generations()):
            if self.verify(gen):
                return gen
        return None


# -- rng state serialization (manifest-friendly) ----------------------------
def rng_to_json(generator: torch.Generator) -> list:
    """A ``torch.Generator``'s state as a JSON list of byte values (bit-exact
    round-trip; the port's counterpart of JAX's ``key_to_json``)."""
    return [int(x) for x in generator.get_state().tolist()]


def rng_from_json(generator: torch.Generator, words) -> torch.Generator:
    """Set ``generator`` to a state written by ``rng_to_json``."""
    generator.set_state(torch.tensor(words, dtype=torch.uint8))
    return generator
