"""Quantized-inference engine of the port (counterpart of the JAX
``serve.py::InferenceEngine``), for every net of the registry
(``models.MODEL_NAMES`` and the ResNet-50 STL / Swish variants).

    engine = InferenceEngine("resnet", qbit=8)        # on the card
    logits = engine.predict(images_nhwc)               # any batch size
    top1 = engine.classify(images_nhwc)

qbit 8 freezes the weights once (bf16 values, or uint8 SLFP<3,4> codes with
``pack_weights=True``) and serves them either through the fused executor
(``fused``; ResNet-50, the ReLU MobileNetV1 variants and ShuffleNetV2, CIFAR
and ImageNet (``imgnet/shufflenetv2``, a name of the port's own), the
default there) or through the module path
(``create_model(..., frozen_weights=True, use_pallas=...)``), where
``use_pallas`` routes the 1x1 convs and dense layers to K4 as in JAX.
qbit 7 (SFP<3,3>) freezes the weights as values and serves the module path
only.  qbit 32 runs the module path unquantized.  ShuffleNetV2's fused
executor, picked as JAX picks it, runs its 36 affine -> SFP<4,4> -> ReLU
posts as plain PyTorch ops (about 2,200 launches a forward); until they
become one kernel it is the slower SLFP8 route: on an H100 it served
0.92-0.98x the images/s of the packed module path (``fused=False,
pack_weights=True``) at batch 64 and 0.79-0.85x at 256 (``chip_smoke.py``,
in turns, two runs).  InceptionV3 is float32 only: it serves at qbit 32 and refuses
qbit 7 and 8, which JAX's engine cannot serve either.  A ``checkpoint``
ending in ``.pth`` is a reference PyTorch state_dict, matched by position
as JAX's ``load_pth`` matches it.  The engine runs on ``device="cuda"``
unless the caller asks for ``device="cpu"``; without a card the default
raises.

On the card the engine serves through one CUDA graph, as JAX's serves
through one ``jax.jit`` call: the first :meth:`InferenceEngine.forward`
(or ``predict``) captures the whole forward on the engine's fixed input,
``[batch_size // data, image_size, image_size, 3]`` float32, under the
flags the eager forward enters (``utils/profiling.py::GraphedForward``),
and every later call copies its input in and replays the graph; ``predict``
pads each chunk to that batch, so its last chunk replays the same graph.
``forward`` refuses another shape, and a capture that fails raises.  The
engine stays eager on the CPU (``device="cpu"``) and by one rule on the
card: over a model axis > 1 the forward gathers shards through
``torch.distributed`` every call, which a CUDA graph cannot hold.
``graphed`` says which of the two an engine does.

While spans record (``utils.profiling.on``: a torch.profiler session, or
``profiling.recording()``) each ``forward`` records ``engine.forward``
with ``engine.copy_in``, ``engine.replay`` and ``engine.clone`` (graphed)
or ``engine.eager``, counts ``engine.requests``, and on the card times the
device's wait since the engine's previous request, where both were
recorded in one stretch (``engine.wait``: from that request's last stream
operation to this one's first, between CUDA events, so the caller's copy
to the host and its turn-around lie inside).  An executor with device
phases (ShuffleNetV2's ``shufflenet.*``, ``FusedWeights.phases``) records
their events inside the graph, and each recorded graphed request registers
its replay's (``StepPhases.pend``), as ``GraphedTrainStep`` does for
``train.*``.  The build always records ``engine.build`` with ``model.create``,
``engine.load``, ``engine.freeze`` and ``engine.prepare``.

``mesh=`` (``parallel.make_mesh``) serves over a ``("data", "model")``
mesh, every rank building the engine with the same arguments:
``batch_size`` is the global batch and each rank runs its ``batch_size //
data`` rows; ``predict`` / ``classify`` return the whole batch's on every
rank, as JAX returns a global array.  Over a model axis every fused
executor keeps out-channel shards (``shard_weights`` of
``resnet50_fused``, ``mobilenetv1_fused`` and ``shufflenetv2_fused``),
gathering per forward what its hand kernels read whole, and the module
path shards its layers (``parallel.mesh.shard_module``).
"""

from __future__ import annotations

import importlib
from typing import Optional

import numpy as np
import torch

from cnns_slfp_quantization_tpu_torch import calib, models
from cnns_slfp_quantization_tpu_torch.ops import freeze
from cnns_slfp_quantization_tpu_torch.ops.backend import backend_flags
from cnns_slfp_quantization_tpu_torch.parallel import comm
from cnns_slfp_quantization_tpu_torch.parallel import mesh as mesh_lib
from cnns_slfp_quantization_tpu_torch.parallel.steps import place_rows
from cnns_slfp_quantization_tpu_torch.train import checkpoint as ckpt_lib
from cnns_slfp_quantization_tpu_torch.utils import profiling

# nets with a fused executor -> its module (JAX serve.py:63-70): CIFAR
# mobilenet has a quantized classifier, ImageNet mobilenetv1 a float32 one;
# mobilenet_swish and shufflenetv2_swish keep the module path
FUSABLE = {
    "resnet": "resnet50_fused", "resnet50": "resnet50_fused",
    "imgnet/resnet": "resnet50_fused",
    "mobilenet": "mobilenetv1_fused", "cifar/mobilenet": "mobilenetv1_fused",
    "mobilenetv1": "mobilenetv1_fused",
    "imgnet/mobilenetv1": "mobilenetv1_fused",
    "shufflenetv2": "shufflenetv2_fused",
    "cifar/shufflenetv2": "shufflenetv2_fused",
    "imgnet/shufflenetv2": "shufflenetv2_fused",
}
FLOAT_ONLY = ("inceptionv3", "imgnet/inceptionv3")


def default_image_size(net: str) -> int:
    """32 for a bare CIFAR name, 224 for any other: JAX's rule
    (``serve.py:85-86``) on the name as given, so ``"cifar/mobilenet"``
    gets 224."""
    return (models.INPUT_SIZE["cifar"] if net in models.MODEL_NAMES["cifar"]
            else models.INPUT_SIZE["imgnet"])


class InferenceEngine:
    def __init__(
        self,
        net: str,
        *,
        checkpoint: Optional[str] = None,
        qbit: int = 8,
        batch_size: int = 64,
        image_size: Optional[int] = None,
        pack_weights: bool = False,
        compute_dtype: Optional[torch.dtype] = torch.bfloat16,
        use_pallas: Optional[bool] = False,
        fused: Optional[bool] = None,
        policy: Optional[dict] = None,
        scales=None,
        device: str = "cuda",
        seed: int = 0,
        generator: Optional[torch.Generator] = None,
        mesh=None,
    ):
        """``checkpoint``: a reference PyTorch state_dict (a path ending in
        ``.pth``, read by :func:`train.checkpoint.load_pth`), or else a
        state_dict of the port's model saved with ``torch.save``; without
        one the weights are flax's initializers
        drawn from ``generator`` (or a CPU generator seeded with ``seed``),
        the same on every device.  ``scales``: a calib.ScaleSet or a path to
        a scale JSON; the shipped constants otherwise.

        ``fused=None`` picks the fused executor for SLFP8 ResNet-50,
        MobileNetV1 and ShuffleNetV2 unless the caller asks for K4
        (``use_pallas=True``) or float32 numerics (``compute_dtype=None``);
        ``fused=True`` on another net or qbit raises.  ``policy`` goes to
        the fused executor (keys ``conv1``/``conv3`` and ``chain`` for
        ResNet-50, ``dw`` for MobileNetV1, none for ShuffleNetV2); by
        default ResNet-50's stride-1 bottlenecks of stages 2 and 3 run
        through K6, one launch each, and ``policy={"chain": frozenset()}``
        runs them as JAX's default placement does.
        ``image_size`` defaults to :func:`default_image_size`."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "InferenceEngine runs on the card by default and found no "
                "CUDA device; pass device='cpu' to run on the CPU")
        if qbit not in (7, 8, 32):
            raise ValueError(f"qbit {qbit}: expected 7 (SFP<3,3>), 8 "
                             f"(SLFP<3,4>) or 32 (unquantized)")
        if net in FLOAT_ONLY and qbit != 32:
            raise ValueError(f"{net} is float32 only (no quantized layer to "
                             f"freeze): serve it at qbit=32")
        if isinstance(scales, (str, bytes)) or hasattr(scales, "read_text"):
            scales = calib.load_scales_path(scales)
        fusable = net in FUSABLE
        if fused is None:
            fused = (fusable and qbit == 8 and use_pallas is not True
                     and compute_dtype == torch.bfloat16)
        elif fused and not (fusable and qbit == 8):
            raise ValueError(
                f"fused=True requires net in {sorted(FUSABLE)} and qbit=8 (the "
                f"fused executor consumes SLFP<3,4> frozen weights, float "
                f"or packed uint8); got {net!r}, qbit {qbit}")
        self.fused = fused
        self.qbit = qbit
        self.batch_size = batch_size
        self.mesh = mesh
        model_axis = 1
        if mesh is not None:
            data = mesh_lib.axis_size(mesh, "data")
            model_axis = mesh_lib.axis_size(mesh, "model")
            if batch_size % data:
                raise ValueError(f"batch size {batch_size} not divisible by "
                                 f"the data-parallel mesh axis ({data})")
        self.image_size = image_size or default_image_size(net)
        self.policy = policy
        with profiling.span("engine.build"):
            with profiling.span("model.create"):
                if generator is None:
                    generator = torch.Generator().manual_seed(seed)
                model = models.create_model(
                    net, qbit, scales=scales, compute_dtype=compute_dtype,
                    use_pallas=use_pallas, image_size=self.image_size,
                    generator=generator)
            if checkpoint:
                with profiling.span("engine.load"):
                    if str(checkpoint).endswith(".pth"):
                        ckpt_lib.load_jax_variables(
                            model, ckpt_lib.load_pth(checkpoint, model))
                    else:
                        model.load_state_dict(torch.load(
                            checkpoint, map_location="cpu",
                            weights_only=True))
            model.eval()
            if qbit in (7, 8):
                with profiling.span("engine.freeze"):
                    # packing targets the SLFP<3,4> codes: qbit 7 stores
                    # values
                    if pack_weights and qbit == 8:
                        freeze.pack(model)
                    else:
                        freeze.prequantize(
                            model, torch.bfloat16 if fused else
                            compute_dtype or torch.float32)
            with profiling.span("engine.prepare"):
                if fused:
                    executor = importlib.import_module(
                        f"cnns_slfp_quantization_tpu_torch.models."
                        f"{FUSABLE[net]}")
                    self.executor = executor.prepare(model,
                                                     device=self.device)
                    if model_axis > 1:
                        self.executor = executor.shard_weights(
                            self.executor, mesh)
                    self._eager = lambda x: executor.fused_apply(
                        self.executor, x, policy=self.policy)
                else:
                    self.model = model.to(self.device)
                    if model_axis > 1:
                        mesh_lib.shard_module(self.model, mesh)
                    self._eager = (self._quantized_module if qbit in (7, 8)
                                   else self.model)
        local = batch_size // (1 if mesh is None
                               else mesh_lib.axis_size(mesh, "data"))
        self.input_shape = (local, self.image_size, self.image_size, 3)
        self.graphed = self.device.type == "cuda" and model_axis == 1
        self._graph = None        # captured at the first call (graphed)
        # the executor's device phases, registered after each recorded replay
        self._phases = (getattr(self.executor, "phases", None) if fused
                        else None)
        # the last recorded request's last event, and its stretch (epoch)
        self._tail = None

    def _quantized_module(self, x: torch.Tensor) -> torch.Tensor:
        """The qbit 7 / 8 module path (K4 where ``use_pallas`` routes an
        SLFP8 layer, K1 for the other layers' input quantize) under the
        fused executors' numerics flags: without deterministic cuDNN, packed
        and float-frozen weights would not give the same bits."""
        with backend_flags():
            return self.model(x)

    def _dispatch(self, x: torch.Tensor) -> torch.Tensor:
        """The forward as the engine serves it: the graph's replay, whose
        output tensor the next replay overwrites, where ``graphed`` (the
        capture at the first call); else the eager forward."""
        if not self.graphed:
            with torch.inference_mode():
                return self._eager(x)
        if tuple(x.shape) != self.input_shape or x.dtype != torch.float32:
            raise ValueError(
                f"the engine's graph takes float32 {self.input_shape} (its "
                f"fixed batch); got {x.dtype} {tuple(x.shape)}: predict() "
                f"pads any batch to it")
        if self._graph is None:
            self._graph = profiling.GraphedForward(self._eager, x,
                                                   spans="engine")
        return self._graph(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Logits for an NHWC float32 batch already on the engine's device
        (under a mesh: the rank's rows), at the engine's fixed input shape
        where it serves through its graph; a tensor of its own, which no
        later call overwrites."""
        rec = profiling.on()
        wait = rec and self.device.type == "cuda"
        with profiling.span_if(rec, "engine.forward"):
            if wait:
                first = torch.cuda.Event(enable_timing=True)
                first.record()
            if self.graphed:
                if rec and self._phases is not None:
                    profiling.poll()    # the last replay's phases, if passed
                y = self._dispatch(x)   # engine.copy_in, engine.replay
                if rec and self._phases is not None:
                    self._phases.pend()
                with profiling.span_if(rec, "engine.clone"), \
                        torch.inference_mode():
                    y = y.clone()
            else:
                with profiling.span_if(rec, "engine.eager"):
                    y = self._dispatch(x)
            if wait:
                self._wait(first)
            if rec:
                profiling.count("engine.requests")
            else:
                self._tail = None     # no wait across unrecorded requests
        return y

    def _wait(self, first) -> None:
        """Close a recorded request on the card: its last event, and
        ``engine.wait`` from the previous recorded request's last event to
        ``first``, where both lie in one recording stretch."""
        last = torch.cuda.Event(enable_timing=True)
        last.record()
        tail, self._tail = self._tail, (last, profiling.STORE.epoch)
        if tail is not None and tail[1] == profiling.STORE.epoch:
            profiling.device_span("engine.wait", tail[0], first)
        profiling.poll()

    def predict(self, images) -> np.ndarray:
        """float32 logits for NHWC float32 images; any leading batch size,
        padded internally to the fixed batch."""
        x = np.asarray(images, np.float32)
        n = x.shape[0]
        out = []
        for s in range(0, n, self.batch_size):
            chunk = x[s:s + self.batch_size]
            pad = self.batch_size - chunk.shape[0]
            if pad:
                chunk = np.concatenate(
                    [chunk, np.zeros((pad,) + chunk.shape[1:], np.float32)])
            xb = torch.from_numpy(chunk).to(self.device)
            if self.mesh is None:
                y = self._dispatch(xb)
            else:
                y = comm.gather_rows(
                    self._dispatch(place_rows(self.mesh, xb)), self.mesh)
            out.append(y[:self.batch_size - pad].float().cpu().numpy())
        return np.concatenate(out)[:n]

    def classify(self, images) -> np.ndarray:
        """Top-1 class ids."""
        return np.argmax(self.predict(images), axis=-1)

    def throughput(self, iters: int = 16) -> float:
        """Images per second at the fixed batch size, as JAX's engine times
        its scan (``utils/profiling.py::scan_throughput``): ``iters``
        forwards on zeros perturbed per forward, the fastest of three timed
        runs after one untimed run.  On the card the forwards are replays
        of the engine's own graph (or, over a model axis, eager calls),
        timed by CUDA events; on the CPU eager calls on the host's clock.
        Under a mesh each rank times its share and every rank returns the
        global batch over the slowest rank's time."""
        x = torch.zeros(self.input_shape, dtype=torch.float32,
                        device=self.device)
        ips = profiling.scan_throughput(self._dispatch, x, steps=iters,
                                        graph=False)
        if self.mesh is None:
            return ips
        return comm.global_rate(self.input_shape[0], ips, self.batch_size,
                                self.mesh)
