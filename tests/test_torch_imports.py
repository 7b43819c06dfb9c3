"""tpu_fhe_torch, chip_smoke.py and the port's examples (examples/torch_*.py)
import neither jax nor tpu_fhe, and the port's slices (the u64 plan's and the q32
plan's modules alike, the rotation path of ops/galois.py and
eval/hoisting.py, the evaluation layer of eval/auto.py, eval/chebyshev.py
and eval/jit.py, the bootstrap of boot/boot_math.py and boot/bootstrap.py
with the encoder's QlP forms, and the PPML layers and ResNet-20 of
models/dnn.py, models/resnet20.py and utils/timer.py, and BFV and BGV with
the batch encoder) run with both blocked."""

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "tpu_fhe_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|tpu_fhe)(\.|\s|$)", re.MULTILINE)


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        yield ".".join(p for p in rel.parts if p != "__init__")


def test_sources_name_no_jax_or_reference():
    for path in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py",
                 *(ROOT / "examples").glob("torch_*.py")]:
        text = path.read_text()
        assert not FORBIDDEN.search(text), f"{path} imports jax or tpu_fhe"


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['tpu_fhe'] = None\n"
        "import importlib\n"
        f"for name in {list(_modules())!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'tpu_fhe.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_q32_slice_runs_with_jax_blocked():
    """The q32 composite-scaling path (create_composite, int32 keys and
    ciphertexts, relinearize, rescale_composite) on the CPU, in a process
    where importing jax or tpu_fhe fails."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['tpu_fhe'] = None\n"
        "import numpy as np, torch\n"
        "from tpu_fhe_torch.core.modulus import CoeffModulus\n"
        "from tpu_fhe_torch.core.params import EncryptionParameters, SchemeType\n"
        "from tpu_fhe_torch.eval import evaluator as ev\n"
        "from tpu_fhe_torch.scheme.ckks_encoder import CkksEncoder\n"
        "from tpu_fhe_torch.scheme.context import FheContext\n"
        "from tpu_fhe_torch.scheme.keys import SecretKey\n"
        "n = 1024\n"
        "mods = CoeffModulus.create_composite(n, 58, 2, special_count=3)\n"
        "ctx = FheContext(EncryptionParameters(SchemeType.ckks, n, tuple(mods),\n"
        "    special_modulus_size=3, composite_degree=2, allow_insecure=True), device='cpu')\n"
        "sk, enc = SecretKey(ctx, seed=1), CkksEncoder(ctx)\n"
        "x = np.random.default_rng(0).standard_normal(n // 2)\n"
        "ct = sk.encrypt_symmetric(enc.encode(x, 2.0 ** 58))\n"
        "out = ev.rescale_composite(ctx, ev.relinearize(ctx, ev.square(ctx, ct),\n"
        "                                               sk.relin_key()))\n"
        "assert out.data.dtype == torch.int32 and out.chain_index == 3\n"
        "assert np.max(np.abs(enc.decode(sk.decrypt(out)).real - x * x)) < 1e-9\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_rotation_path_runs_with_jax_blocked():
    """Galois keys, rotate (keyed and NAF-composed), conjugate and a hoisted
    rotation sum on the CPU, in a process where importing jax or tpu_fhe
    fails."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['tpu_fhe'] = None\n"
        "import numpy as np\n"
        "from tpu_fhe_torch.core.modulus import CoeffModulus\n"
        "from tpu_fhe_torch.core.params import EncryptionParameters, SchemeType\n"
        "from tpu_fhe_torch.eval import evaluator as ev, hoisting as ho\n"
        "from tpu_fhe_torch.ops import galois\n"
        "from tpu_fhe_torch.scheme.ckks_encoder import CkksEncoder\n"
        "from tpu_fhe_torch.scheme.context import FheContext\n"
        "from tpu_fhe_torch.scheme.keys import SecretKey\n"
        "n = 1024\n"
        "ctx = FheContext(EncryptionParameters(SchemeType.ckks, n,\n"
        "    tuple(CoeffModulus.create(n, [60, 40, 40, 60])), special_modulus_size=1,\n"
        "    allow_insecure=True), device='cpu')\n"
        "sk, enc = SecretKey(ctx, seed=1), CkksEncoder(ctx)\n"
        "gk = sk.galois_key([-1, 4], include_conj=True)\n"
        "x = np.random.default_rng(0).standard_normal(n // 2) * (1 + 1j)\n"
        "ct = sk.encrypt_symmetric(enc.encode(x, 2.0 ** 40))\n"
        "def err(c, want):\n"
        "    return np.max(np.abs(enc.decode(sk.decrypt(c)) - want))\n"
        "assert err(ev.rotate(ctx, ct, 3, gk), np.roll(x, -3)) < 1e-6\n"
        "assert err(ev.conjugate(ctx, ct, gk), np.conj(x)) < 1e-6\n"
        "assert err(ho.hoisted_rotation_sum(ctx, ct, (0, -1, 4), gk),\n"
        "           x + np.roll(x, 1) + np.roll(x, -4)) < 1e-6\n"
        "assert galois.conj_elt(n) in gk.keys\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_evaluation_layer_runs_with_jax_blocked():
    """eval/auto.py, eval/chebyshev.py and eval/jit.py on the CPU, in a
    process where importing jax or tpu_fhe fails: a Chebyshev series
    through the FLEXIBLEAUTO layer, raise_mod and the Evaluator's eager
    path."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['tpu_fhe'] = None\n"
        "import math\n"
        "import numpy as np\n"
        "from tpu_fhe_torch.core.modulus import CoeffModulus\n"
        "from tpu_fhe_torch.core.params import EncryptionParameters, SchemeType\n"
        "from tpu_fhe_torch.eval import auto, chebyshev as cheb\n"
        "from tpu_fhe_torch.eval.jit import Evaluator\n"
        "from tpu_fhe_torch.scheme.ckks_encoder import CkksEncoder\n"
        "from tpu_fhe_torch.scheme.context import FheContext\n"
        "from tpu_fhe_torch.scheme.keys import SecretKey\n"
        "n = 128\n"
        "ctx = FheContext(EncryptionParameters(SchemeType.ckks, n,\n"
        "    tuple(CoeffModulus.create(n, [45] + [40] * 5 + [50])), special_modulus_size=1,\n"
        "    allow_insecure=True), device='cpu')\n"
        "sk, enc = SecretKey(ctx, seed=1), CkksEncoder(ctx)\n"
        "rlk = sk.relin_key()\n"
        "x = np.random.default_rng(0).uniform(-1, 1, n // 2)\n"
        "ct = sk.encrypt_symmetric(enc.encode(x, auto.default_scale(ctx)))\n"
        "coeffs = cheb.eval_chebyshev_coefficients(math.exp, -1.0, 1.0, 4)\n"
        "out = cheb.eval_chebyshev_series(ctx, ct, rlk, coeffs, -1.0, 1.0)\n"
        "assert np.max(np.abs(enc.decode(sk.decrypt(out)).real - np.exp(x))) < 1e-2\n"
        "raised = auto.raise_mod(ctx, auto.mod_switch_level(ctx, ct, 5))\n"
        "assert raised.chain_index == 1\n"
        "E = Evaluator(ctx)\n"
        "sq = E.rescale(E.square_relin(ct, rlk))\n"
        "assert np.max(np.abs(enc.decode(sk.decrypt(sq)).real - x * x)) < 1e-4\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_bootstrap_runs_with_jax_blocked():
    """boot/bootstrap.py (setup with the encoder's QlP plaintexts and sparse
    encode, keygen, the sparse eval_bootstrap) on a q32 context at N = 64 on
    the CPU, in a process where importing jax or tpu_fhe fails."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['tpu_fhe'] = None\n"
        "import numpy as np\n"
        "from tpu_fhe_torch.boot.bootstrap import CkksBootstrapper\n"
        "from tpu_fhe_torch.core.modulus import CoeffModulus\n"
        "from tpu_fhe_torch.core.params import EncryptionParameters, SchemeType\n"
        "from tpu_fhe_torch.eval import auto, evaluator as ev\n"
        "from tpu_fhe_torch.scheme.ckks_encoder import CkksEncoder\n"
        "from tpu_fhe_torch.scheme.context import FheContext\n"
        "from tpu_fhe_torch.scheme.keys import SecretKey\n"
        "n, slots = 64, 8\n"
        "mods = CoeffModulus.create_composite(n, 56, 15, degree=2, anchor_bits=30,\n"
        "                                     special_bits=30, special_count=4)\n"
        "ctx = FheContext(EncryptionParameters(SchemeType.ckks, n, tuple(mods),\n"
        "    special_modulus_size=4, composite_degree=2, allow_insecure=True), device='cpu')\n"
        "sk, enc = SecretKey(ctx, seed=1), CkksEncoder(ctx)\n"
        "boot = CkksBootstrapper(ctx, enc)\n"
        "boot.set_sine_params(28, 3, 44)\n"
        "boot.setup(level_budget=(2, 2), slots=slots)\n"
        "boot.keygen(sk, slots)\n"
        "x = np.random.default_rng(0).uniform(-0.8, 0.8, slots)\n"
        "ct = sk.encrypt_symmetric(enc.encode(x, auto.default_scale(ctx), slots=slots))\n"
        "while ctx.level(ct.chain_index).size > 4:\n"
        "    ct = ev.mod_drop_to_next(ctx, ct)\n"
        "out = boot.eval_bootstrap(ct, slots)\n"
        "assert out.chain_index < ct.chain_index\n"
        "assert np.max(np.abs(enc.decode(sk.decrypt(out), slots=slots).real - x)) < 1e-4\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_resnet20_stem_runs_with_jax_blocked():
    """resnet20_infer's stem (a device-encoded conv, batch norm and
    relu_composite with its three bootstraps) on a q32 context at N = 64,
    width 4, on the CPU, in a process where importing jax or tpu_fhe fails:
    within 1e-4 of the float64 shadow with the same sign composite, with the
    timer buckets filled."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['tpu_fhe'] = None\n"
        "import numpy as np\n"
        "from tpu_fhe_torch.boot.bootstrap import CkksBootstrapper\n"
        "from tpu_fhe_torch.core.modulus import CoeffModulus\n"
        "from tpu_fhe_torch.core.params import EncryptionParameters, SchemeType\n"
        "from tpu_fhe_torch.models import resnet20 as rn\n"
        "from tpu_fhe_torch.models.dnn import DNN, relu_composite_clear\n"
        "from tpu_fhe_torch.scheme.ckks_encoder import CkksEncoder\n"
        "from tpu_fhe_torch.scheme.context import FheContext\n"
        "from tpu_fhe_torch.scheme.keys import SecretKey\n"
        "from tpu_fhe_torch.utils import timer\n"
        "n, depth = 64, 23\n"
        "mods = CoeffModulus.create_composite(n, 58, depth, degree=2, anchor_bits=30,\n"
        "                                     special_bits=30, special_count=depth + 1)\n"
        "ctx = FheContext(EncryptionParameters(SchemeType.ckks, n, tuple(mods),\n"
        "    special_modulus_size=depth + 1, composite_degree=2, allow_insecure=True),\n"
        "    device='cpu')\n"
        "sk, enc = SecretKey(ctx, seed=1), CkksEncoder(ctx)\n"
        "model = DNN(ctx, enc)\n"
        "rn.prepare_resnet20(model, sk, width=4, layers=1)\n"
        "boot = CkksBootstrapper(ctx, enc)\n"
        "boot.set_sine_params(28, 3, 44)\n"
        "boot.setup(level_budget=(2, 2), slots=16)\n"
        "boot.keygen(sk, 16)\n"
        "model.mul_key = boot.mul_key\n"
        "rng = np.random.default_rng(17)\n"
        "w = rn.random_weights(rng, planes=(1, 1, 1))\n"
        "img = rng.uniform(-0.5, 0.5, (4, 4, 3))\n"
        "out = rn.resnet20_infer(model.enc_tensor(img, sk=sk), model, boot, w,\n"
        "                        log=lambda m: None, blocks=0, layers=1)\n"
        "want = rn.resnet20_infer_clear(img, w, relu=relu_composite_clear, blocks=0,\n"
        "                               layers=1)\n"
        "assert np.max(np.abs(model.dec_tensor(out, sk) - want)) < 1e-4\n"
        "assert timer.counts() == {'Convolution': 1, 'BatchNorm': 1, 'Relu': 3,\n"
        "                          'Bootstrap': 3}\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_bfv_bgv_run_with_jax_blocked():
    """BFV (BEHZ multiply, relinearize, rotate_rows) and BGV (multiply,
    relinearize, mod_switch_to_next) with the batch encoder at N = 256 on the
    CPU, in a process where importing jax or tpu_fhe fails."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['tpu_fhe'] = None\n"
        "import numpy as np\n"
        "from tpu_fhe_torch.core.modulus import CoeffModulus, PlainModulus\n"
        "from tpu_fhe_torch.core.params import EncryptionParameters, SchemeType\n"
        "from tpu_fhe_torch.eval import bfv_eval as bv, bgv_eval as bg\n"
        "from tpu_fhe_torch.scheme.batch_encoder import BatchEncoder\n"
        "from tpu_fhe_torch.scheme.bfv import BfvTools\n"
        "from tpu_fhe_torch.scheme.bgv import BgvTools\n"
        "from tpu_fhe_torch.scheme.context import FheContext\n"
        "from tpu_fhe_torch.scheme.keys import SecretKey\n"
        "n = 256\n"
        "t = PlainModulus.batching(n, 20)\n"
        "a = np.random.default_rng(0).integers(0, t.value, n, dtype=np.uint64)\n"
        "want = a.astype(object) * a.astype(object) % t.value\n"
        "for scheme, Tools in ((SchemeType.bfv, BfvTools), (SchemeType.bgv, BgvTools)):\n"
        "    ctx = FheContext(EncryptionParameters(scheme, n,\n"
        "        tuple(CoeffModulus.create(n, [50, 50, 50, 60])), special_modulus_size=1,\n"
        "        plain_modulus=t, allow_insecure=True), device='cpu')\n"
        "    sk, enc, tools = SecretKey(ctx, seed=1), BatchEncoder(ctx), Tools(ctx)\n"
        "    ct = tools.encrypt_symmetric(sk, enc.encode(a))\n"
        "    ev = bv if scheme == SchemeType.bfv else bg\n"
        "    first = tools if scheme == SchemeType.bfv else ctx\n"
        "    sq = ev.relinearize(first, ev.multiply(tools, ct, ct), sk.relin_key())\n"
        "    assert np.array_equal(enc.decode(tools.decrypt(sk, sq)), want)\n"
        "    sw = ev.mod_switch_to_next(tools, sq)\n"
        "    assert np.array_equal(enc.decode(tools.decrypt(sk, sw)), want)\n"
        "    if scheme == SchemeType.bfv:\n"
        "        r = bv.rotate_rows(tools, ct, 1, sk.galois_key([1]))\n"
        "        assert np.array_equal(enc.decode(tools.decrypt(sk, r)).reshape(2, -1),\n"
        "                              np.roll(a.reshape(2, -1), -1, axis=1))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
