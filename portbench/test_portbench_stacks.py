"""The reference's layer stacks, found by the model's family
(``reference.stacks.stack_for``): the lookup, a family brought by one new
file and nothing else, and values pinned from the weights, operations and
launches as they were before the stacks moved into modules of their own."""

from __future__ import annotations

import hashlib
import json
import math
import re
from pathlib import Path

import pytest
import torch

from portbench import feed, flops
from portbench.reference import stacks
from portbench.reference.model import param_spec, sequence_nll
from portbench.reference.train import reference_run
from portbench.test_portbench_reference import SMOKE
from portbench.weights import load_into, make_weights

HERE = Path(__file__).resolve().parent
CONFIGS = {name: json.loads((HERE / "configs" / f"{name}.json").read_text())["model"]
           for name in ("hubert-xlarge", "mamba2-1.3b")}
CONTRACT = ("stack_spec", "stack", "stack_ops", "launches_per_step")


def test_lookup_resolves_the_families():
    found = {family: Path(stacks.stack_for({"family": family}).__file__).name
             for family in ("dense", "audio", "ssm")}
    assert found == {"dense": "attention.py", "audio": "attention.py", "ssm": "mamba2.py"}
    assert stacks.stack_for({"family": "dense"}) is stacks.stack_for({"family": "audio"})


@pytest.mark.parametrize("path", sorted(p for p in stacks.DIR.glob("*.py")
                                        if p.name != "__init__.py"), ids=lambda p: p.name)
def test_each_stack_module_keeps_the_contract(path):
    module = next(m for m in stacks._modules(stacks.DIR) if Path(m.__file__) == path)
    assert isinstance(module.FAMILIES, tuple) and module.FAMILIES
    assert all(callable(getattr(module, name)) for name in CONTRACT)
    for family in module.FAMILIES:
        assert stacks.stack_for({"family": family}) is module


def _no_stack(family: str) -> dict:
    """mamba2-1.3b's sizes under another family: every size an SSM stack
    reads is there, so nothing but the lookup can refuse it."""
    return dict(CONFIGS["mamba2-1.3b"], family=family, num_layers=1, d_model=8,
                vocab_size=10, ssm_state=4, ssm_head_dim=4, ssm_chunk=4)


@pytest.mark.parametrize("use", ["stack_for", "param_spec", "sequence_nll", "forward_ops",
                                 "step_ops", "launches_per_step"])
@pytest.mark.parametrize("family", ["hybrid", "moe", "vlm", "no-such-family"])
def test_a_family_with_no_stack_raises_everywhere(family, use):
    model = _no_stack(family)
    tokens = torch.zeros((1, 4), dtype=torch.long)
    calls = {
        "stack_for": lambda: stacks.stack_for(model),
        "param_spec": lambda: param_spec(model),
        "sequence_nll": lambda: sequence_nll({"embed": torch.zeros(10, 8)}, model,
                                             {"tokens": tokens, "labels": tokens}),
        "forward_ops": lambda: flops.forward_ops(model, 4),
        "step_ops": lambda: flops.step_ops(model, 2, 4),
        "launches_per_step": lambda: flops.launches_per_step(model),
    }
    where = re.escape(f"'{family}'") + ".*" + re.escape(str(stacks.DIR))
    with pytest.raises(NotImplementedError, match=where):
        calls[use]()


def test_two_modules_claiming_one_family_raise(tmp_path, monkeypatch):
    for name in ("first", "second"):
        (tmp_path / f"{name}.py").write_text('FAMILIES = ("shared", "own_' + name + '")\n')
    monkeypatch.setattr(stacks, "DIR", tmp_path)
    assert Path(stacks.stack_for({"family": "own_second"}).__file__).name == "second.py"
    where = re.escape(f"'shared' family is claimed by first.py, second.py, all in {tmp_path}")
    with pytest.raises(ValueError, match=where):
        stacks.stack_for({"family": "shared"})


TOY = '''"""A toy family: each layer x + x w, one (d, d) product, and a D leaf."""
from portbench.flops import step_launches
from portbench.reference.model import dense, run_layers

FAMILIES = ("toy",)


def stack_spec(model):
    d = model["d_model"]
    return [leaf for i in range(model["num_layers"])
            for leaf in (dense(f"layers.{i}.w", d, d), (f"layers.{i}.D", (d,), "ones", 0.0))]


def block(p, pre, x, model, mm):
    return x + mm(x, p[pre + "w"]) * p[pre + "D"]


def stack(p, model, x, mm, remat):
    return run_layers(block, p, model, x, mm, remat)


def stack_ops(model, seq):
    return model["num_layers"] * 2 * seq * model["d_model"] ** 2


def launches_per_step(model):
    return step_launches()
'''


def test_a_new_family_is_one_new_file(tmp_path, monkeypatch):
    """A family written outside the tree drives the weights, their load into a
    program's tree, the reference's first job, the operations and the
    launches with no other change."""
    for path in stacks.DIR.glob("*.py"):
        (tmp_path / path.name).write_text(path.read_text())
    (tmp_path / "toy.py").write_text(TOY)
    monkeypatch.setattr(stacks, "DIR", tmp_path)
    model = dict(family="toy", num_layers=2, d_model=8, vocab_size=16, dtype="bfloat16")
    mix = dict(models=1, job_batch=3, seq_len=5, input="tokens", lr=1e-3,
               adam=dict(b1=0.9, b2=0.999, eps=1e-8))

    weights = make_weights(model, 7, 0, "cpu")
    assert list(weights) == ["embed", "final_norm.gamma", "head", "layers.0.w", "layers.0.D",
                             "layers.1.w", "layers.1.D"]
    assert weights["layers.1.D"].dtype == torch.float32     # the default f32 suffixes
    assert weights["layers.1.w"].dtype == torch.bfloat16
    tree = {"embed": torch.zeros(16, 8, dtype=torch.bfloat16),
            "final_norm": {"gamma": torch.zeros(8, dtype=torch.bfloat16)},
            "head": torch.zeros(8, 16, dtype=torch.bfloat16),
            "layers": [{"w": torch.zeros(8, 8, dtype=torch.bfloat16),
                        "D": torch.zeros(8)} for _ in range(2)]}
    load_into(tree, weights)
    assert torch.equal(tree["layers"][1]["w"], weights["layers.1.w"])

    batch = feed.job_batch(mix, model, 7, 0, 1, "cpu", torch.bfloat16)
    out = reference_run(model, mix, lambda m: make_weights(model, 7, m, "cpu"),
                        lambda j: batch, jobs=1, rows=2)
    p = {k: v.float() for k, v in weights.items()}
    x = p["embed"][batch["tokens"]]
    for i in range(2):
        x = x + x @ p[f"layers.{i}.w"] * p[f"layers.{i}.D"]
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) * p["final_norm.gamma"]
    logp = torch.log_softmax((x @ p["head"])[:, :-1], dim=-1)
    want = -logp.gather(-1, batch["labels"][:, 1:, None])[..., 0].mean(dim=1).mean()
    assert out["losses"][1] == pytest.approx(want.item(), rel=1e-6)
    assert set(out["grad_norms"][0]) == set(weights)
    assert all(math.isfinite(v) for v in out["change_norms"][0].values())
    assert out["change_norms"][0]["layers.1.w"] > 0 and out["change_norms"][0]["layers.1.D"] > 0

    assert flops.step_ops(model, 4, 5) == 3 * 4 * (2 * 5 * 8 * 16 + 2 * 2 * 5 * 8 * 8)
    assert flops.launches_per_step(model) == flops.step_launches() == {
        "flash_attention": 0, "flash_attention_bwd": 0, "rmsnorm": 1, "rmsnorm_bwd": 1,
        "ssd_chunk_scan": 0, "ssd_chunk_scan_bwd": 0, "ssd_intra_chunk": 0, "coded_combine": 0}
    # the tree's own families still resolve beside the new one
    assert flops.launches_per_step(CONFIGS["mamba2-1.3b"])["ssd_chunk_scan"] == 96


# -- values pinned from commit 83c41b0, before the stacks moved into modules of their own --

PARAM_SPEC = {
    "hubert-xlarge": (435, "866fd9b89742790d0d2a1437181d06419dc701586fe95ab13dc96f008ab10afc"),
    "mamba2-1.3b": (434, "7780efb2a3c76bc95ead85fac1d39d834d717c02740bf0524d4a30e92dd9df1b"),
}
WEIGHTS = {   # make_weights at test_portbench_reference.py's smoke sizes, seed 7, on the CPU
    ("hubert-xlarge", "float32"):
        "63d3f56484ed43a2025c6899bac8abf6a5d3ffe77ce3c971d8ab896b9b46e7bb",
    ("hubert-xlarge", "bfloat16"):
        "273618ee992f6d36f9090c32074f5200d8e2504d525beeb4ff85529d376bb744",
    ("mamba2-1.3b", "float32"):
        "863f10087e3f698cac0ffd0b39317f4f1985907942749a41c2521fa99585d7a0",
    ("mamba2-1.3b", "bfloat16"):
        "7155fb236e0bb65e411f714eb836d16b4106cd59c314fc9707821177815602f8",
}
FORWARD_OPS = {("hubert-xlarge", 500): 1_320_376_320_000, ("mamba2-1.3b", 256): 717_084_950_528}
LAUNCHES = {
    "hubert-xlarge": {"flash_attention": 96, "flash_attention_bwd": 48, "rmsnorm": 193,
                      "rmsnorm_bwd": 97, "ssd_chunk_scan": 0, "ssd_chunk_scan_bwd": 0,
                      "ssd_intra_chunk": 0, "coded_combine": 0},
    "mamba2-1.3b": {"flash_attention": 0, "flash_attention_bwd": 0, "rmsnorm": 193,
                    "rmsnorm_bwd": 97, "ssd_chunk_scan": 96, "ssd_chunk_scan_bwd": 48,
                    "ssd_intra_chunk": 0, "coded_combine": 0},
}


@pytest.mark.parametrize("name", sorted(PARAM_SPEC))
def test_param_spec_is_the_parents_at_published_sizes(name):
    spec = param_spec(CONFIGS[name])
    digest = hashlib.sha256(json.dumps(spec).encode()).hexdigest()
    assert (len(spec), digest) == PARAM_SPEC[name]


@pytest.mark.parametrize("name, dtype", sorted(WEIGHTS))
def test_make_weights_is_the_parents_bit_for_bit(name, dtype):
    model = {**CONFIGS[name], **SMOKE[name], "dtype": dtype}
    digest = hashlib.sha256()
    for path, t in make_weights(model, 7, 0, "cpu").items():
        digest.update(f"{path} {t.dtype} {tuple(t.shape)}".encode())
        digest.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    assert digest.hexdigest() == WEIGHTS[name, dtype]


@pytest.mark.parametrize("name, seq", sorted(FORWARD_OPS))
def test_forward_ops_are_the_parents(name, seq):
    assert flops.forward_ops(CONFIGS[name], seq) == FORWARD_OPS[name, seq]


@pytest.mark.parametrize("name", sorted(LAUNCHES))
def test_launches_per_step_are_the_parents(name):
    assert flops.launches_per_step(CONFIGS[name]) == LAUNCHES[name]
