"""The port stands without jax and the repo's JAX tools, and without the
packages the GPU host lacks (PIL, cv2, transformers, tokenizers,
safetensors, regex, ftfy); its CLIs answer --help and refuse to run
without a card unless asked for the CPU, and its chip smoke refuses to
run on a machine without a CUDA device. Every public name of the JAX package has a counterpart in the
same file of the port, or is on an allowlist that names the port's way."""

import ast
import importlib.util
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]


def _run(args, cwd=ROOT):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    env["CUDA_VISIBLE_DEVICES"] = ""       # no card, whatever the host has
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_never_imports_jax():
    code = ("import sys\n"
            "import omg_tpu_torch.pipelines.omg, omg_tpu_torch.from_jax\n"
            "import omg_tpu_torch.ops.flash_attention\n"
            "import omg_tpu_torch.parallel.launch\n"
            "import omg_tpu_torch.parallel.mesh\n"
            "import omg_tpu_torch.segment, omg_tpu_torch.segment.detector\n"
            "import omg_tpu_torch.segment.detector_eval\n"
            "import omg_tpu_torch.segment.sam_provider\n"
            "import omg_tpu_torch.models.clip_vision\n"
            "import omg_tpu_torch.models.controlnet\n"
            "import omg_tpu_torch.models.resampler\n"
            "import omg_tpu_torch.instantid\n"
            "import omg_tpu_torch.diffusion.schedulers\n"
            "import omg_tpu_torch.convert, omg_tpu_torch.loader\n"
            "import omg_tpu_torch.checkpoint, omg_tpu_torch.utils.image\n"
            "import omg_tpu_torch.cli.inference_lora\n"
            "import omg_tpu_torch.cli.inference_instantid\n"
            "import omg_tpu_torch.text.tokenizer\n"
            "import omg_tpu_torch.serving.conditions\n"
            "import omg_tpu_torch.serving.registry\n"
            "import omg_tpu_torch.serving.server\n"
            "import omg_tpu_torch.serving.warmup\n"
            "import omg_tpu_torch.serving.mesh\n"
            "import omg_tpu_torch.utils.profiling\n"
            "import omg_tpu_torch.cli.serve\n"
            "import omg_tpu_torch.utils.jpeg, omg_tpu_torch.utils.cv\n"
            "import omg_tpu_torch.models.openpose\n"
            "import omg_tpu_torch.models.dpt\n"
            "import omg_tpu_torch.ops.quant\n"
            "import omg_tpu_torch.parallel.sharding\n"
            "import omg_tpu_torch.parallel.dryrun\n"
            "import omg_tpu_torch.tools.serve_bench\n"
            "import omg_tpu_torch.tools.soak_bench\n"
            "import omg_tpu_torch.tools.fidelity_harness\n"
            "import omg_tpu_torch.tools.validate_detector\n"
            "import omg_tpu_torch.bench\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'omg_tpu', 'tools', 'PIL',\n"
            "              'cv2', 'transformers', 'safetensors', 'regex',\n"
            "              'ftfy', 'tokenizers', 'insightface'))\n"
            "assert not bad, bad\n")
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr


# Public names of omg_tpu/ that the port does another way or needs not:
# {file: {name: the port's counterpart or the reason}}. Every file's
# "Array" (jax.Array) and "Params" (dict trees) are torch.Tensor and
# nn.Module in the port; the functional ``apply`` / ``init_*`` forms are
# modules' ``forward`` and ``layers.init_params``.
ANOTHER_WAY = {
    "checkpoint.py": {"save_pytree": "save_module / save_sdxl",
                      "load_pytree": "load_module / load_sdxl"},
    "convert.py": {"state_dict_to_tree": "copy_into (state dicts fill the "
                                         "modules directly)"},
    "diffusion/schedulers.py": {k: "KINDS, string Schedule.kind" for k in
                                ("EULER", "DDIM", "DPMPP_2M", "LCM")},
    "models/unet.py": {"AttnControl": "control.p2p.P2PControl.at_step",
                       "apply_shallow": "UNet2DConditionModel.apply_shallow",
                       "pack_params": "not ported: an XLA compile-time "
                                      "workaround (ROADMAP header)"},
    "models/vae.py": {"encode": "AutoencoderKL.encode",
                      "decode": "AutoencoderKL.decode"},
    "nn/attention.py": {"ProbsTransform": "the P2P control of Attention",
                        "init_ip_kv": "IPKV", "init_mha": "Attention",
                        "mha": "Attention.forward",
                        "sdpa_with_probs": "Attention.forward (P2P lanes)"},
    "nn/layers.py": {"avg_pool_2x": "called nowhere in omg_tpu",
                     "conv2d": "Conv2d", "group_norm": "GroupNorm",
                     "layer_norm": "LayerNorm", "linear": "Linear",
                     "silu": "torch.nn.functional.silu",
                     **{k: "init_params" for k in (
                         "init_conv2d", "init_embedding", "init_linear",
                         "init_norm")}},
    "ops/flash_attention.py": {
        "DEFAULT_BQ": "launch_plan's tiles", "DEFAULT_BK": "launch_plan's "
        "tiles", "TRACE_STATS": "not ported: a GSPMD bypass guard "
                                "(ROADMAP header)",
        **{k: "explicit rank groups: flash_attention_seq_sharded(group=), "
              "nn.attention.seq_sharded_sdpa, parallel.mesh" for k in (
                  "flash_attention_sharded", "lane_context", "lane_sharded",
                  "seq_context", "seq_sharded")}},
    "ops/quant.py": {"quantize_linear": "nn.layers.QuantLinear",
                     "quantize_unet_params": "quantize_unet"},
    "segment/efficientvit.py": {k: "Backbone / SamNeck / "
                                   "EfficientViTSamImageEncoder.forward"
                                for k in ("backbone_apply", "encoder_apply",
                                          "neck_apply")},
    "segment/evit_ops.py": {
        "batch_norm": "BatchNorm", "conv2d_raw": "Conv",
        "conv_layer": "ConvLayer", "evit_block": "EfficientViTBlock",
        "fused_mbconv": "FusedMBConv", "layer_norm_2d": "LayerNorm2d",
        "lite_mla": "LiteMLA", "mbconv": "MBConv", "res_block": "ResBlock"},
    "segment/sam_decoder.py": {"two_way_transformer": "TwoWayTransformer"},
    "segment/vit_sam.py": {"encoder_apply": "the image encoder's forward"},
    "utils/profiling.py": {
        "start_server": "not ported: the XLA profiler server (ROADMAP "
                        "header)",
        "compiled_peak_bytes": "not ported: torch.cuda.max_memory_allocated "
                               "(ROADMAP header)",
        "device_memory_stats": "removed: nothing in the port, the server or "
                               "the benchmark read it"},
}
EVERY_FILE = {"Array": "torch.Tensor", "Params": "nn.Module",
              "apply": "the module's forward"}


def _public_names(path: pathlib.Path, imports: bool = False) -> set:
    """Top-level defs, classes and assigned names of a file (and, with
    ``imports``, the names it imports), without the private ones."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            names |= {n.id for t in targets for n in ast.walk(t)
                      if isinstance(n, ast.Name)}
        elif imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return {n for n in names if not n.startswith("_")}


def test_every_public_name_has_a_counterpart():
    """Read both packages with ``ast`` (nothing imported): each public
    top-level name of ``omg_tpu/**/*.py`` is defined or imported in the
    same file of ``omg_tpu_torch/``, or is on the allowlist above; and
    the allowlist names nothing that is not missing."""
    missing, stale = {}, {}
    for path in sorted((ROOT / "omg_tpu").rglob("*.py")):
        rel = path.relative_to(ROOT / "omg_tpu").as_posix()
        twin = ROOT / "omg_tpu_torch" / rel
        assert twin.exists(), f"no omg_tpu_torch/{rel}"
        gap = _public_names(path) - _public_names(twin, imports=True)
        allowed = ANOTHER_WAY.get(rel, {})
        if gap - set(allowed) - set(EVERY_FILE):
            missing[rel] = sorted(gap - set(allowed) - set(EVERY_FILE))
        if set(allowed) - gap:
            stale[rel] = sorted(set(allowed) - gap)
    assert not missing, missing
    assert not stale, stale


def test_cli_help_and_no_card():
    """``--help`` needs no card; a run that asks for none fails at once
    for want of one, before any file is read."""
    proc = _run(["-m", "omg_tpu_torch.cli.inference_lora", "--help"])
    assert proc.returncode == 0, proc.stderr
    assert "--lora_path" in proc.stdout and "--device" in proc.stdout
    proc = _run(["-m", "omg_tpu_torch.cli.inference_instantid", "--help"])
    assert proc.returncode == 0 and "--face_adapter_path" in proc.stdout
    proc = _run(["-m", "omg_tpu_torch.cli.inference_lora",
                 "--pretrained_sdxl_model", "no/such/dir"])
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "no/such/dir" not in proc.stderr


def test_serve_cli_help_and_no_card():
    proc = _run(["-m", "omg_tpu_torch.cli.serve", "--help"])
    assert proc.returncode == 0, proc.stderr
    assert "--registry" in proc.stdout and "--device" in proc.stdout
    proc = _run(["-m", "omg_tpu_torch.cli.serve",
                 "--pretrained_sdxl_model", "no/such/dir"])
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "no/such/dir" not in proc.stderr


def test_examples_never_import_jax():
    """The port's examples (``examples/torch_*.py``), imported as modules
    (their ``main`` not run), load neither jax nor the JAX package."""
    names = sorted(p.stem for p in (ROOT / "examples").glob("torch_*.py"))
    assert names == ["torch_full_pipeline", "torch_multichip_latency",
                     "torch_quickstart_random_weights"]
    code = ("import importlib, sys\n"
            f"sys.path.insert(0, {str(ROOT / 'examples')!r})\n"
            f"for name in {names!r}:\n"
            "    assert callable(importlib.import_module(name).main)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'omg_tpu', 'PIL'))\n"
            "assert not bad, bad\n")
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr


# Arguments of a run that reaches the models: the validator skips unless
# its files exist (any existing paths do: it asks for the card first).
NO_CARD_ARGV = {
    "fidelity_harness": ["--self_check"],
    "validate_detector": ["--sam_checkpoint", "chip_smoke.py",
                          "--clip_checkpoint", "chip_smoke.py",
                          "--tokenizer_dir", "tests", "--images",
                          "README.md"]}


@pytest.mark.parametrize("tool", ["serve_bench", "soak_bench",
                                  "fidelity_harness", "validate_detector",
                                  "bench"])
def test_tool_help_and_no_card(tool):
    """Each tool's ``--help`` parses without a card; a run that asks for
    none fails at once for want of one."""
    module = ("omg_tpu_torch.bench" if tool == "bench"
              else f"omg_tpu_torch.tools.{tool}")
    proc = _run(["-m", module, "--help"])
    assert proc.returncode == 0, proc.stderr
    assert "--device" in proc.stdout and "--out" in proc.stdout
    proc = _run(["-m", module, *NO_CARD_ARGV.get(tool, [])])
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr


def test_chip_smoke_fails_without_a_card():
    proc = _run([str(ROOT / "chip_smoke.py")])
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_chip_smoke_times_k1_at_the_controlnet_batches():
    """Phase 3 holds K1 at the batches the conditioned paths give it:
    1 (guess mode's cond row), 3 (the stage-2 base rows) and 4 (the
    IdentityNet on the concept lanes), at both self-attention shapes."""
    spec = importlib.util.spec_from_file_location("chip_smoke_shapes",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    want = {(b, h, n, 64) for b in (1, 3, 4)
            for h, n in ((10, 4096), (20, 1024))}
    assert want <= set(mod.KERNEL_SHAPES)
    assert (mod.CN_PATH_LAUNCHES, mod.IID_PATH_LAUNCHES) == (8736, 7036)


def test_chip_smoke_serving_counts():
    """Phase 3 holds K1 at every shape phase 10 launches it at (R = 4: B =
    8 in stage 1, 28 in stage 2; R = 2 with config #5's ControlNets: 4, 6,
    8 and 14; guess mode: 1, 2 and 7), and phase 10 (a) expects its
    launches per shape."""
    spec = importlib.util.spec_from_file_location("chip_smoke_serving",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    want = {(b, h, n, 64) for b in (8, 28)
            for h, n in ((10, 4096), (20, 1024))}
    assert want <= set(mod.KERNEL_SHAPES)
    assert mod.BATCH_SHAPE_LAUNCHES == {
        "8,10,4096,64": 500, "8,20,1024,64": 3000,
        "28,10,4096,64": 340, "28,20,1024,64": 2040}
    assert sum(mod.BATCH_SHAPE_LAUNCHES.values()) == 5880
    checked = {",".join(map(str, shape)) for shape in mod.KERNEL_SHAPES}
    for table in (mod.BATCH_SHAPE_LAUNCHES, mod.CONFIG5_SHAPES,
                  mod.GUESS_SHAPES, mod.HTTP_SHAPES):
        assert set(table) <= checked


def test_chip_smoke_preprocessor_counts():
    """Phase 11 (d) expects two requests' launches at 6 steps with the
    ControlNet on both stages (as config #3), at shapes phase 3 checks."""
    spec = importlib.util.spec_from_file_location("chip_smoke_pre",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    per_request = mod.path_launches(mod.SERVE_CHECK_STEPS,
                                    70 + mod.CN_LAUNCHES, 70 + mod.CN_LAUNCHES)
    assert sum(mod.PRE_HTTP_SHAPES.values()) == 2 * per_request == 1872
    checked = {",".join(map(str, shape)) for shape in mod.KERNEL_SHAPES}
    assert set(mod.PRE_HTTP_SHAPES) <= checked
    assert (mod.PRE_DPT_CONFIG.hidden_size, mod.PRE_OPENPOSE_WIDTH) == \
        (1024, 1.0)


def test_chip_smoke_approximate_counts():
    """Phase 3 holds K1 at every shape phase 12 launches it at (the crop
    strips' [4, 10, 2048, 64] among them); DeepCache at interval 3 on
    config #2 expects 6 + 12 full forwards at b = 2 and 12 at b = 7 (2100
    launches), the "front" schedule the count its own full steps give,
    and the ControlNet beside the full forwards only."""
    spec = importlib.util.spec_from_file_location("chip_smoke_approx",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    checked = {",".join(map(str, shape)) for shape in mod.KERNEL_SHAPES}
    assert "4,10,2048,64" in checked
    assert mod.deepcache_forwards(50, 3) == (18, 12)
    uniform = mod.forward_shapes(18, 12)
    assert sum(uniform.values()) == mod.DC_UNIFORM_LAUNCHES == 2100
    front = mod.multiconcept.deepcache_schedule(50, 3, kind="front",
                                                fusion_start=15)
    n1, n2 = mod.deepcache_forwards(50, front)
    assert n1 >= sum(front) and n2 == sum(front[16:]) + (not front[16])
    config3 = mod.forward_shapes(18, 12, cn1=2, cn2=3)
    assert sum(config3.values()) == 30 * (70 + mod.CN_LAUNCHES)
    assert sum(mod.CROP_SHAPES.values()) == 3500 + 340 + 2040 + 340
    assert mod.deepcache_forwards(6, 2) == (4, 2)
    for table in (uniform, mod.forward_shapes(n1, n2), config3,
                  mod.CROP_SHAPES):
        assert set(table) <= checked
    assert set(mod.JPEG_NEW_FIXTURES) <= {
        p.stem for p in (ROOT / "tests" / "port" / "data").glob("*.jpg")}


def test_chip_smoke_mesh_conditioned_counts():
    """Phase 3 holds K1 at every shape phase 13 and phase 5b launch it at
    (the TP forward's 5 and 10 local heads at b = 4, the mesh stage 2's 4
    lanes a rank, the CLI's one lane a rank in stage 1, the 4-row
    program's b = 4) and phase 3b K1b at the H-split stage 1's; the
    launch counts are the ones reckoned from the code: (70 + 34) x 6 K1b
    with the ControlNet, 3 stage-2 steps of 104 or 70 K1 a rank."""
    spec = importlib.util.spec_from_file_location("chip_smoke_mesh13",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    checked = {",".join(map(str, shape)) for shape in mod.KERNEL_SHAPES}
    assert mod.TP_SHAPES == {"4,5,4096,64": 10, "4,10,1024,64": 60}
    assert sum(mod.TP_SHAPES.values()) == mod.LAUNCHES_PER_FORWARD
    assert mod.MESH_CN_LAUNCHES == (624, (312, 210))
    assert mod.MESH_IID_LAUNCHES == (420, (210, 312))
    assert mod.MESH_CLI_LAUNCHES == 630
    stage2 = mod.forward_shapes(0, 3, lanes2=4, cn2=4)
    cli = mod.forward_shapes(6, 3, lanes1=1, lanes2=4)
    ref = mod.forward_shapes(2 * mod.REF_STEPS + 3, 0, 4)
    assert sum(ref.values()) == 1050
    assert sum(mod.forward_shapes(mod.REF_STEPS, 3).values()) == 630
    for table in (mod.TP_SHAPES, stage2, cli, ref):
        assert set(table) <= checked
    assert {(2, 10, 2048, 4096), (2, 20, 512, 1024)} <= set(mod.SEQ_SHAPES)


def test_chip_smoke_harness_counts():
    """Phase 9 (e) expects K1 at the shapes one 20-step run gives it (2
    lanes, then 7), all of them shapes phase 3 checks, and twice that
    with the stub reference answered by the live engine."""
    spec = importlib.util.spec_from_file_location("chip_smoke_harness",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    checked = {",".join(map(str, shape)) for shape in mod.KERNEL_SHAPES}
    assert mod.HARNESS_SHAPES == {
        "2,10,4096,64": 200, "2,20,1024,64": 1200,
        "7,10,4096,64": 130, "7,20,1024,64": 780}
    assert set(mod.HARNESS_SHAPES) <= checked
    assert sum(mod.HARNESS_SHAPES.values()) == mod.HARNESS_LAUNCHES == \
        mod.path_launches(20, 70, 70) == 2310


def test_chip_smoke_serving_tools_counts():
    """Phase 15 (a) expects K1 at the shapes the single request (2 lanes,
    then 7) and the pair and the ceiling call (4, then 14) give it at 20
    steps, all of them shapes phase 3 checks, and the strip provider's
    calls of every request that runs stage 2; (b) runs at phase 10 (d)'s
    depth with a bound well inside the mix-up margin."""
    spec = importlib.util.spec_from_file_location("chip_smoke_tools",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    checked = {",".join(map(str, shape)) for shape in mod.KERNEL_SHAPES}
    assert mod.TOOLS_SINGLE_SHAPES == {
        "2,10,4096,64": 200, "2,20,1024,64": 1200,
        "7,10,4096,64": 130, "7,20,1024,64": 780}
    assert mod.TOOLS_PAIR_SHAPES == {
        "4,10,4096,64": 200, "4,20,1024,64": 1200,
        "14,10,4096,64": 130, "14,20,1024,64": 780}
    for table in (mod.TOOLS_SINGLE_SHAPES, mod.TOOLS_PAIR_SHAPES):
        assert set(table) <= checked
        # phase 10 (d)'s requests at the same depth: 2310 each
        assert sum(table.values()) == sum(mod.HTTP_SHAPES.values()) == 2310
    assert (mod.TOOLS_SIZE, mod.TOOLS_R, mod.TOOLS_STEPS) == ("sdxl", 2, 20)
    assert mod.TOOLS_MASK_CALLS == 2 * (1 + 2 + 2 + 1 + 2 + 2) == 20
    assert mod.SOAK_STEPS == mod.CONFIG5_STEPS == 20
    assert mod.SOAK_SEPARATION * mod.SOAK_MEAN_BOUND <= 32


def test_chip_smoke_bench_counts():
    """Phase 16 expects K1 in each bench run's timed call at the shapes
    a generation at 10 steps gives it (``path_launches(10, 70, 70)`` by
    shape): 2 lanes, then 7, at 1024² and at the 1216x832 bucket (3952
    and 988 tokens), and 4, then 14 for the throughput pair, and 4, then
    6 and 8 strip lanes for the pair with the crop strips; phase 3 checks
    every one of those shapes, the other buckets' stage-2 ones and the
    crop strips' at four requests a chunk.
    """
    spec = importlib.util.spec_from_file_location("chip_smoke_bench",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    checked = {",".join(map(str, shape)) for shape in mod.KERNEL_SHAPES}
    per_call = mod.path_launches(mod.BENCH_STEPS, 70, 70)
    assert (mod.BENCH_STEPS, mod.BENCH_BUCKET, mod.BENCH_R, per_call) == \
        (10, (1216, 832), 2, 1120)
    assert mod.BENCH_SHAPES == mod.serve_shapes(10, 2, 7) == {
        "2,10,4096,64": 100, "2,20,1024,64": 600,
        "7,10,4096,64": 60, "7,20,1024,64": 360}
    assert mod.BENCH_BUCKET_SHAPES == {
        "2,10,3952,64": 100, "2,20,988,64": 600,
        "7,10,3952,64": 60, "7,20,988,64": 360}
    assert mod.BENCH_PAIR_SHAPES == {
        "4,10,4096,64": 100, "4,20,1024,64": 600,
        "14,10,4096,64": 60, "14,20,1024,64": 360}
    for table in (mod.BENCH_SHAPES, mod.BENCH_BUCKET_SHAPES,
                  mod.BENCH_PAIR_SHAPES):
        assert sum(table.values()) == per_call
        assert set(table) <= checked
    # (e) the pair with the crop strips: 2R = 4 lanes in stage 1, then
    # per stage-2 step 3R = 6 base lanes and 2KR = 8 strip lanes whose
    # level 1 holds 2048 tokens (level 2's 512 stay off K1)
    assert mod.BENCH_CROP_SHAPES == {
        "4,10,4096,64": 100, "4,20,1024,64": 600,
        "6,10,4096,64": 60, "6,20,1024,64": 360, "8,10,2048,64": 60}
    assert sum(mod.BENCH_CROP_SHAPES.values()) == 1180
    assert set(mod.BENCH_CROP_SHAPES) <= checked
    # and the bench's crop rows at CHUNK=4: 12 base lanes, 16 strip lanes
    assert {"12,10,4096,64", "12,20,1024,64", "16,10,2048,64"} <= checked
    # every non-square bucket's stage-1 and stage-2 shapes
    for h, w in mod.conditions.RESOLUTIONS[1:]:
        assert set(mod.serve_shapes(10, 2, 7, height=h, width=w)) <= checked
    assert mod.DETECTOR_SWEEP == [0.12, 0.15, 0.18, 0.22, 0.26, 0.30]
