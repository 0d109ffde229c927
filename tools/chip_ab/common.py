"""Helpers of the kernel A/B scripts in this directory: build copies of a
``csrc`` directory (patched or not) into shared libraries beside the package's
own, swap one into ``trajopt_torch``'s loader, time launches queued back to
back, and compare outputs bit for bit.

The scripts run on a machine with a CUDA card, from the root of a checkout:

    python3 tools/chip_ab/<script>.py [--kernels SET] [--parent DIR] [--out FILE]

``--kernels`` picks the set of kernels a script measures (each script lists
its sets, one a redesign: ``K11,K12,K2,K3`` for the eLQR sweeps and K2/K3's
quotient, ``K6,K7,K13`` for the GPS backward and the eLQR rollout, ``K7,K8``
for the GPS forward KL and the belief-value backward, ``K5`` for the
parallel-in-time backward, …).

``--parent`` names the ``csrc`` directory of the commit to compare against,
unpacked beforehand, for example with
``mkdir -p build/chip_ab/parent && git archive HEAD~1 trajopt_torch/csrc | tar -x -C build/chip_ab/parent``
(then ``build/chip_ab/parent/trajopt_torch/csrc``, the default).  Each script
prints JSON lines and, with ``--out``, writes its results there.
"""
import argparse
import ctypes
import hashlib
import inspect
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
import torch  # noqa: E402

from trajopt_torch.kernels import _build  # noqa: E402

WORK = ROOT / "build" / "chip_ab"
LIB = WORK / "lib"
NEW = ROOT / "trajopt_torch" / "csrc"
libs = {}
reports = {}


def args(kernel_sets):
    """The options, ``--kernels`` one of ``kernel_sets`` (the first by default)."""
    p = argparse.ArgumentParser()
    p.add_argument("--kernels", choices=list(kernel_sets), default=list(kernel_sets)[0])
    p.add_argument("--parent", type=Path, default=WORK / "parent" / "trajopt_torch" / "csrc")
    p.add_argument("--out", type=Path, default=None)
    return p.parse_args()


def run(kernel_sets):
    """Parse the options and run the body ``kernel_sets[--kernels](opts, res)``,
    ``res`` the results (the card's name, power limit and clocks at the start
    and the end), dumped to ``--out``."""
    opts = args(kernel_sets)
    res = {"card": card()}
    log(res["card"])
    kernel_sets[opts.kernels](opts, res)
    res["card_end"] = card()
    dump(opts.out, res)
    log("done; failed:", res.get("failures", []))


def log(*a):
    print(*a, flush=True)


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def lib_path(label):
    """The shared library of a build label (its characters other than
    letters, digits, '.' and '-' made '_', which nvcc's file names allow)."""
    return LIB / (re.sub(r"[^\w.-]", "_", label) + ".so")


def build_variants(specs):
    """Compile ``{label: source .cu path}`` with the package's nvcc flags, all
    in parallel, and load each library under its label."""
    LIB.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {label: subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-o", str(lib_path(label)), str(src)],
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for label, src in specs.items()}
    for label, p in procs.items():
        txt, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{label}: nvcc failed\n{txt}")
        regs = [line.strip() for line in txt.splitlines() if "registers" in line]
        log(f"built {label}: " + " | ".join(regs))
        reports[label] = ptxas_report(txt)
        libs[label] = ctypes.CDLL(str(lib_path(label)))


def ptxas_report(txt):
    """{kernel's mangled name: [registers, spill stores, spill loads]} from
    ``-Xptxas -v``'s output."""
    out, name = {}, None
    for line in txt.splitlines():
        if "Function properties for " in line:
            name = line.split("Function properties for ")[1].strip()
        elif name and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            out.setdefault(name, [None, None, None])[1:] = nums[1:3]
        elif name and "Used " in line and "registers" in line:
            out.setdefault(name, [None, None, None])[0] = int(line.split("Used ")[1].split()[0])
    return {k: v for k, v in out.items() if k.startswith("_Z") and "kernel" in k}


def use(source, label):
    """Make the package's wrappers of ``source`` launch library ``label``."""
    _build._loaded[source] = libs[label]


def patched_copy(src_dir, files, label):
    """Copy the sources of ``src_dir`` to ``WORK/label``, applying
    ``{file name: [(old, new, count)]}``; each ``old`` must occur ``count``
    times."""
    dest = WORK / label
    dest.mkdir(parents=True, exist_ok=True)
    for f in Path(src_dir).iterdir():
        if f.suffix in (".cu", ".cuh"):
            (dest / f.name).write_text(f.read_text())
    for name, subs in files.items():
        text = (dest / name).read_text()
        for old, new, count in subs:
            if text.count(old) != count:
                raise RuntimeError(f"{label}/{name}: {old!r} found {text.count(old)} times, not {count}")
            text = text.replace(old, new)
        (dest / name).write_text(text)
    return dest


def back_to_back(fn, reps):
    """Device ms per call of ``fn``, its launches queued behind a sleep."""
    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e8))
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def flat(xs):
    """The tensors of nested tuples and lists (named tuples too), in order."""
    for x in xs:
        if isinstance(x, (tuple, list)):
            yield from flat(x)
        else:
            yield x


def digest(tensors):
    """SHA-256 (16 hex digits) of the tensors' bits (a nested tuple or list of
    them), NaNs made canonical."""
    h = hashlib.sha256()
    for t in flat(tensors):
        t = t.detach()
        if t.is_floating_point():
            t = torch.where(torch.isnan(t), torch.full_like(t, float("nan")), t)
            t = t.contiguous().view(torch.int32 if t.dtype == torch.float32 else torch.int64)
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def capture(module_names, fn_names, run):
    """Run ``run()`` with the wrappers ``fn_names`` (in each of the modules
    ``module_names``) replaced by ones that keep their arguments, keyword
    ones as positional, tensors cloned; return ``{fn name: [args, ...]}``."""
    kept = {n: [] for n in fn_names}
    saved = []
    for mod in module_names:
        for n in fn_names:
            if hasattr(mod, n):
                orig = getattr(mod, n)

                def keeping(*a, _n=n, _orig=orig, _sig=inspect.signature(orig), **kw):
                    args = _sig.bind(*a, **kw).args
                    kept[_n].append([x.clone() if torch.is_tensor(x) else x for x in args])
                    return _orig(*a, **kw)
                keeping.launches = 0
                saved.append((mod, n, orig))
                setattr(mod, n, keeping)
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for mod, n, orig in saved:
            setattr(mod, n, orig)
    return kept


def dump(path, obj):
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(obj, indent=1))


def k5_call(label, cost, A, B, cluster=None):
    """One launch of K5 from library ``label`` on CUDA tensors, outputs (K,
    kff, S, s, dV): with ``cluster`` None through the entry point of the
    kernels before the cluster route (no route argument: the one-block
    global-scratch kernel), else through this tree's with that route
    argument (0 the global route, C a cluster of C blocks)."""
    T, dx, du = A.shape[0], A.shape[-1], B.shape[-1]
    ins = [x.contiguous() for x in (cost.Cxx, cost.cx, cost.Cuu, cost.cu, cost.Cxu, A, B)]
    kw = dict(dtype=A.dtype, device=A.device)
    outs = [torch.empty(T, du, dx, **kw), torch.empty(T, du, **kw), torch.empty(T + 1, dx, dx, **kw),
            torch.empty(T + 1, dx, **kw), torch.empty(2, **kw)]
    scratch = torch.empty(2 * (3 * dx * dx + 2 * dx) * (T + 1), **kw)
    fn = libs[label].trajopt_pscan_backward
    P, I = ctypes.c_void_p, ctypes.c_int
    route = [] if cluster is None else [cluster]
    fn.argtypes = [I, I, I] + [P] * 13 + [I] * (1 + len(route)) + [P]
    code = _build.DTYPE_CODES[str(A.dtype)]
    rc = fn(code, dx, du, *(t.data_ptr() for t in ins + outs + [scratch]), T, *route,
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, f"K5 {label}")
    return outs


def k5_wrapper(label, cluster=None):
    """A stand-in for ``cuda_pscan.cuda_pilqr_backward`` (its contract) that
    launches K5 from library ``label`` as :func:`k5_call` does."""
    from trajopt_torch.core.types import LinearPolicy, QuadraticValue

    def call(cost, A, B):
        K, kff, S, s, dV = k5_call(label, cost, A, B, cluster)
        return (LinearPolicy(K=K, kff=kff),
                QuadraticValue(V=S, v=s, v0=torch.zeros_like(s[:, 0])), dV)
    return call
