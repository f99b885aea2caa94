"""Export and load of the HSIViT classifier for serving.

Counterpart of ``hsimae_tpu/serving/export.py``. :func:`torch.export.export`
takes the place of ``jax.export``: the classifier forward is exported once
per batch bucket and platform (``cpu``, ``cuda``) at a static batch, and the
programs, the weights and the model metadata go into one file. Requests of
``n`` patches are padded up to the smallest bucket >= n; larger requests
stream through the largest bucket in chunks.

The encoder blocks run the registered op ``torch.ops.hsimae.fused_block``
(:func:`hsimae_tpu_torch.ops.fused_block.fused_block_op`): in a CUDA program
that is the route's hand-written kernel, in a CPU program the plain version.
Every weight is an input of the program, none is stored in it. The kernel
layouts of the block weights (:func:`kernel_weights`) are built once, when
the artifact is loaded, never per request; the artifact stores what the JAX
package's stores: the weights, cast by ``params_dtype``, or their int8
quantization. Unlike the JAX program, which dequantizes inside itself on
every call, a loaded artifact dequantizes once at load; the arithmetic is
the same.

Loading needs torch and :mod:`hsimae_tpu_torch.ops` (which registers the
op), not the model source. A JAX ``.hsix`` (StableHLO in flax msgpack) is
refused.
"""

from __future__ import annotations

import dataclasses
import io
import os
import re
import warnings
import zlib
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from hsimae_tpu_torch.ops import fused_block

ARTIFACT_VERSION = 1
DEFAULT_BUCKETS = (1, 64, 1024)
DEFAULT_PLATFORMS = ("cpu", "cuda")
CLS_HEAD_NAME = "cls_head"
# the patch embed's Conv3d weight [C, 1, u, p, p] is a Dense kernel [u*p*p, C]
# in the JAX package, which quantizes it like every 2-D kernel
PATCH_EMBED_KEY = "patch_embed.proj.weight"
_Q8_KEYS = frozenset({"q8", "scale"})


def quantize_params_int8(state: Dict[str, torch.Tensor]) -> dict:
    """Weight-only int8: every 2-D float tensor (a ``Linear`` weight
    ``[out, in]``) and the patch embed's weight becomes ``{"q8": int8,
    "scale": float32}``, symmetric per output channel (axis 0): ``s =
    max|w| over the other axes / 127`` (0 -> 1), ``q8 = clip(round(w / s),
    -127, 127)``, the arithmetic of the JAX package's quantizer on its
    ``[in, out]`` kernels. bfloat16 tensors are quantized too, from their
    float32 values; every other tensor stays as it is."""
    out = {}
    for k, t in state.items():
        if t.is_floating_point() and (t.dim() == 2 or k == PATCH_EMBED_KEY):
            tf = t.float()
            s = tf.abs().amax(dim=tuple(range(1, t.dim())), keepdim=True) / 127.0
            s = torch.where(s == 0, torch.ones_like(s), s)
            out[k] = {"q8": torch.clamp(torch.round(tf / s), -127, 127).to(torch.int8),
                      "scale": s}
        else:
            out[k] = t
    return out


def dequantize_params(state: dict, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`quantize_params_int8`: ``q8 * scale`` computed in
    ``dtype`` (the product rounds in ``dtype``, as the JAX program's does)."""
    return {k: v["q8"].to(dtype) * v["scale"].to(dtype)
            if isinstance(v, dict) and set(v) == _Q8_KEYS else v for k, v in state.items()}


def _dtype(name: Optional[str]) -> Optional[torch.dtype]:
    return None if name is None else getattr(torch, str(name).removeprefix("torch."))


def _float32_state(stored: dict, quantize: Optional[str], params_dtype: Optional[str],
                   device) -> Dict[str, torch.Tensor]:
    """The artifact's weights as the model takes them: dequantized in
    ``params_dtype`` (default float32) when quantized, then float32, on
    ``device``."""
    if quantize == "int8":
        stored = dequantize_params(stored, _dtype(params_dtype) or torch.float32)
    return {k: (v.float() if v.is_floating_point() else v).to(device) for k, v in stored.items()}


def _stack_keys(kernel_stacks: Dict[str, int]) -> re.Pattern:
    return re.compile(r"^(%s)\.\d+\." % "|".join(map(re.escape, kernel_stacks)) if kernel_stacks
                      else r"(?!)")


def kernel_inputs(state: Dict[str, torch.Tensor], kernel_stacks: Dict[str, int],
                  dtype: torch.dtype) -> Tuple[dict, dict, dict]:
    """``(rest, blocks, routes)``, the inputs of a program besides ``x``:
    ``rest`` every tensor outside the kernel stacks; ``blocks[name]`` each
    block of stack ``name`` in the form the kernel of stream ``dtype``
    takes (:func:`kernel_weights`), flattened by :func:`pack_tensors`;
    ``routes[name]`` the blocks' routes. Built on the tensors' device."""
    in_stack = _stack_keys(kernel_stacks)
    rest = {k: v for k, v in state.items() if not in_stack.match(k)}
    blocks, routes = {}, {}
    with torch.no_grad():
        for name, n in kernel_stacks.items():
            pairs = [fused_block.pack_tensors(fused_block.kernel_weights(
                fused_block.params_from_state(state, f"{name}.{i}."), dtype)) for i in range(n)]
            routes[name] = [r for r, _ in pairs]
            blocks[name] = [t for _, t in pairs]
    return rest, blocks, routes


class _Applied(nn.Module):
    """``apply_method(module, x)`` as a module's forward, so
    ``functional_call`` can put other tensors in the module's place."""

    def __init__(self, module: nn.Module, apply_method):
        super().__init__()
        self.m = module
        self.apply_method = apply_method

    def forward(self, x):
        return self.m(x) if self.apply_method is None else self.apply_method(self.m, x)


class _Program(nn.Module):
    """What is exported: ``forward(x, rest, blocks)`` runs ``apply_method``
    of the module with ``rest`` in place of its tensors and the kernel
    stacks on ``blocks`` through the registered op. The module is held
    outside ``nn.Module``'s registry, so none of its own tensors is taken
    into the program."""

    def __init__(self, module: nn.Module, routes: dict, apply_method):
        super().__init__()
        self.__dict__["_held"] = (_Applied(module, apply_method), routes)

    def forward(self, x, rest, blocks):
        applied, routes = self._held
        tensors = {f"m.{k}": v for k, v in rest.items()}
        if not routes:
            return torch.func.functional_call(applied, tensors, (x,), strict=False)
        given = {name: list(zip(routes[name], blocks[name])) for name in routes}
        with applied.m.given_kernel_weights(given):
            return torch.func.functional_call(applied, tensors, (x,), strict=False)


def _jsonify(tree):
    """The metadata as plain values: None -> ``"__none__"``, a dtype -> its
    name (``"bfloat16"``), tuples -> lists (:func:`_unjsonify` inverts the
    first)."""
    if isinstance(tree, dict):
        return {k: _jsonify(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_jsonify(v) for v in tree]
    if tree is None:
        return "__none__"
    if isinstance(tree, torch.dtype):
        return str(tree).removeprefix("torch.")
    return tree


def _unjsonify(tree):
    if isinstance(tree, dict):
        return {k: _unjsonify(v) for k, v in tree.items()}
    return None if tree == "__none__" else tree


def export_classifier(
    params: Dict[str, torch.Tensor],
    model_cfg,
    num_classes: int,
    batch_sizes: Sequence[int] = DEFAULT_BUCKETS,
    platforms: Sequence[str] = DEFAULT_PLATFORMS,
    params_dtype: Optional[str] = None,
    quantize: Optional[str] = None,
    device: str | torch.device = "cuda",
) -> bytes:
    """Serialize an HSIViT classifier into a self-contained artifact.

    ``params`` is a state dict with the reference's names covering the
    encoder and the cls head (a fine-tuned DualViT's works: the model takes
    it by key and shape intersection); one that leaves ``cls_head``
    uncovered is refused, other uncovered weights warn. The encoder stacks
    run the fused-block op whatever ``model_cfg.use_kernel`` says.
    ``params_dtype='bfloat16'`` casts float weights before the export
    (half the size; pair it with a bf16 ``compute_dtype``);
    ``quantize='int8'`` then stores the matrices as weight-only int8
    (:func:`quantize_params_int8`). The ``cuda`` programs are exported on
    ``device``."""
    from hsimae_tpu_torch.checkpoints.io import partial_restore
    from hsimae_tpu_torch.models.hsimae import HSIMAE, build_hsi_vit

    if quantize not in (None, "int8"):
        raise ValueError(f"unsupported quantize={quantize!r} (only 'int8')")
    model_cfg = model_cfg.replace(use_kernel=True)
    model = build_hsi_vit(model_cfg, num_classes, seed=0, device="cpu")
    loaded, _ = partial_restore(model, params, verbose=False)
    covered = set(loaded)
    uncovered = [k for k, _ in model.named_parameters() if k not in covered]
    if any(k.split(".")[0] == CLS_HEAD_NAME for k in uncovered):
        raise ValueError(f"checkpoint does not cover {CLS_HEAD_NAME} — wrong num_classes "
                         "or a pretrain-only checkpoint?")
    if uncovered:
        # an export freezes the weights into a deployed artifact: random-init
        # weights stay there for good
        warnings.warn(f"export leaves {len(uncovered)} target leaves at random init (model "
                      "args do not match the checkpoint?); the artifact will produce "
                      "meaningless predictions", stacklevel=2)
    stacks = {name: len(getattr(model, name)) for name in ("blocks_1", "blocks_2", "blocks")
              if len(getattr(model, name))}
    return export_module_classifier(
        model, model.state_dict(), num_classes,
        (model_cfg.img_size, model_cfg.img_size, model_cfg.bands),
        batch_sizes=batch_sizes, platforms=platforms, params_dtype=params_dtype,
        quantize=quantize, apply_method=HSIMAE.classify, meta=dataclasses.asdict(model_cfg),
        kernel_stacks=stacks, kernel_dtype=model_cfg.compute_dtype, device=device)


def export_module_classifier(
    module: nn.Module,
    state: Dict[str, torch.Tensor],
    num_classes: int,
    input_shape: Tuple[int, ...],
    batch_sizes: Sequence[int] = DEFAULT_BUCKETS,
    platforms: Sequence[str] = DEFAULT_PLATFORMS,
    params_dtype: Optional[str] = None,
    quantize: Optional[str] = None,
    apply_method=None,
    meta: Optional[dict] = None,
    kernel_stacks: Optional[Dict[str, int]] = None,
    kernel_dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
) -> bytes:
    """Generic export of a classifier whose eval forward is
    ``apply_method(module, x)`` (default ``module(x)``) with the tensors of
    ``state`` (its state dict): the counterpart of the JAX package's
    ``export_flax_classifier``. ``input_shape`` is one example's shape;
    ``meta`` is stored as the artifact's ``model_cfg``. ``kernel_stacks``
    (block-list name -> blocks) names the module's stacks that run the
    fused-block op on kernel weights of stream dtype ``kernel_dtype``
    (the module must have ``given_kernel_weights``)."""
    if quantize not in (None, "int8"):
        raise ValueError(f"unsupported quantize={quantize!r} (only 'int8')")
    state = {k: v.detach().cpu() for k, v in state.items()}
    if params_dtype is not None:
        cast = _dtype(params_dtype)
        state = {k: v.to(cast) if v.is_floating_point() else v for k, v in state.items()}
    stored = quantize_params_int8(state) if quantize == "int8" else state
    stacks = dict(kernel_stacks or {})
    module = module.eval()
    buckets = sorted(set(int(b) for b in batch_sizes))
    programs: Dict[str, bytes] = {}
    for platform in platforms:
        dev = torch.device(device) if platform == "cuda" else torch.device(platform)
        if dev.type != platform:
            raise ValueError(f"platform {platform!r} needs a {platform} device, got {dev}")
        rest, blocks, routes = kernel_inputs(
            _float32_state(stored, quantize, params_dtype, dev), stacks, kernel_dtype)
        program = _Program(module, routes, apply_method)
        for b in buckets:
            x = torch.zeros((b,) + tuple(input_shape), dtype=torch.float32, device=dev)
            with torch.no_grad():
                ep = torch.export.export(program, (x, rest, blocks), strict=False)
            ep.example_inputs = None  # the program keeps no copy of the weights
            buf = io.BytesIO()
            torch.export.save(ep, buf)
            programs[f"{platform}/{b}"] = zlib.compress(buf.getvalue(), 6)
        del rest, blocks
    bundle = {
        "version": ARTIFACT_VERSION,
        "num_classes": int(num_classes),
        "batch_sizes": buckets,
        "platforms": list(platforms),
        "model_cfg": _jsonify(dict(meta or {})),
        "quantize": _jsonify(quantize),
        "params_dtype": _jsonify(params_dtype),
        "kernel_stacks": stacks,
        "kernel_dtype": _jsonify(kernel_dtype),
        "params": stored,
        "programs": programs,
    }
    buf = io.BytesIO()
    torch.save(bundle, buf)
    return buf.getvalue()


def save_classifier(path: str, blob: bytes) -> str:
    """Write ``blob`` to ``path`` atomically (a temporary name, then
    ``os.replace``)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)
    return path


def program_routes(program: nn.Module) -> set:
    """The routes (:data:`fused_block.ROUTES` values) that an exported
    program's calls of ``torch.ops.hsimae.fused_block`` name."""
    op = torch.ops.hsimae.fused_block.default
    return {node.args[2] for node in program.graph.nodes
            if node.op == "call_function" and node.target is op}


class ExportedClassifier:
    """A loaded serving artifact on ``device``: bucketed, padded, chunked
    inference through the programs of that device's platform (an artifact
    without them raises; the CPU program never stands in for the CUDA one).

    ``predict_logits`` returns ``[n, num_classes]`` float32; ``predict``
    returns 1-based labels with the background logit excluded at argmax.
    numpy in gives numpy out; a tensor gives a tensor on ``device``, kept
    there (no host round trip)."""

    def __init__(self, bundle: dict, device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        self.version = int(bundle["version"])
        self.num_classes = int(bundle["num_classes"])
        self.batch_sizes = sorted(int(b) for b in bundle["batch_sizes"])
        self.platforms = list(bundle["platforms"])
        self.model_meta = _unjsonify(bundle["model_cfg"])  # dtypes as names ("bfloat16")
        self.quantize = _unjsonify(bundle["quantize"])
        self.params_dtype = _unjsonify(bundle["params_dtype"])
        self.params = bundle["params"]
        platform = self.device.type
        if platform not in self.platforms:
            raise ValueError(f"the artifact holds programs for {self.platforms}, not for "
                             f"{platform}; export it again with --platforms {platform}")
        # built once: the weights dequantized or cast, the kernel layouts
        self._rest, self._blocks, routes = kernel_inputs(
            _float32_state(self.params, self.quantize, self.params_dtype, self.device),
            dict(bundle["kernel_stacks"]), _dtype(bundle["kernel_dtype"]))
        self._calls = {
            b: torch.export.load(io.BytesIO(zlib.decompress(
                bundle["programs"][f"{platform}/{b}"]))).module()
            for b in self.batch_sizes}
        built = {r for stack in routes.values() for r in stack}
        for b, call in self._calls.items():
            stale = program_routes(call) - built
            if stale:
                raise ValueError(
                    f"the artifact's bucket-{b} program runs the fused block on route "
                    f"{sorted(stale)}, whose weight layout this library no longer builds for "
                    f"these blocks (it builds {sorted(built)}): export the weights again with "
                    "hsimae_tpu_torch.cli.export")

    def weights(self) -> Dict[str, torch.Tensor]:
        """The float32 weights the programs serve (dequantized or cast as at
        load), on the CPU, with the reference's names."""
        return _float32_state(self.params, self.quantize, self.params_dtype, "cpu")

    def _bucket(self, n: int) -> int:
        for b in self.batch_sizes:
            if b >= n:
                return b
        return self.batch_sizes[-1]

    @torch.inference_mode()
    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.device, torch.float32)
        n = x.shape[0]
        if n == 0:
            return torch.zeros((0, self.num_classes), device=self.device)
        max_b = self.batch_sizes[-1]
        out = []
        for s in range(0, n, max_b):
            chunk = x[s:s + max_b]
            b = self._bucket(chunk.shape[0])
            if chunk.shape[0] < b:
                chunk = torch.cat([chunk, chunk.new_zeros((b - chunk.shape[0],) + chunk.shape[1:])])
            logits = self._calls[b](chunk.contiguous(), self._rest, self._blocks)
            out.append(logits[:min(max_b, n - s)])
        return torch.cat(out)

    def predict_logits(self, x):
        if isinstance(x, torch.Tensor):
            return self._logits(x)
        return self._logits(torch.from_numpy(np.asarray(x, np.float32))).cpu().numpy()

    def predict(self, x):
        logits = self.predict_logits(x)
        if isinstance(logits, torch.Tensor):
            return torch.argmax(logits[:, 1:], dim=1).to(torch.int32) + 1
        return np.argmax(logits[:, 1:], axis=1).astype(np.int32) + 1


def load_classifier(path_or_blob, device: str | torch.device = "cuda") -> ExportedClassifier:
    """Load an artifact of :func:`export_classifier` (a path or its bytes)
    onto ``device``. A JAX ``.hsix`` is refused."""
    if isinstance(path_or_blob, (bytes, bytearray)):
        blob = bytes(path_or_blob)
    else:
        with open(path_or_blob, "rb") as f:
            blob = f.read()
    if not blob.startswith(b"PK\x03\x04"):  # torch.save writes a zip archive
        if blob[:1] and (0x80 <= blob[0] <= 0x8F or blob[0] in (0xDE, 0xDF)):  # a msgpack map
            raise ValueError("this is a JAX .hsix artifact (StableHLO in flax msgpack), which "
                             "the PyTorch port cannot run: export the weights again with "
                             "hsimae_tpu_torch.cli.export")
        raise ValueError("not a serving artifact of hsimae_tpu_torch")
    bundle = torch.load(io.BytesIO(blob), map_location="cpu", weights_only=True)
    if int(bundle["version"]) > ARTIFACT_VERSION:
        raise ValueError(f"artifact version {bundle['version']} is newer than this library "
                         f"supports ({ARTIFACT_VERSION})")
    return ExportedClassifier(bundle, device)
