"""Rule-based per-dataset reward scorers (a copy of
``polyrl_tpu/rewards/scorers.py``): per ``data_source`` routing to gsm8k,
MATH-style, DAPO, prime-math, geo3k, code-execution and QA exact-match
scorers. Pure Python on the host.
"""

from __future__ import annotations

import re


def extract_gsm8k_answer(text: str, method: str = "strict") -> str | None:
    """GSM8K: final number after '####' (strict) or last number (flexible)."""
    if method == "strict":
        m = re.search(r"####\s*(-?[0-9.,]+)", text)
        if m is None:
            return None
        return m.group(1).replace(",", "").rstrip(".")
    nums = re.findall(r"-?[0-9][0-9.,]*", text)
    if not nums:
        return None
    return nums[-1].replace(",", "").rstrip(".")


def _num_eq(a: str, b: str) -> bool:
    try:
        return abs(float(a) - float(b)) < 1e-6
    except (TypeError, ValueError):
        return a == b


def compute_score_gsm8k(
    solution_str: str,
    ground_truth: str,
    method: str = "flexible",
    correct_score: float = 1.0,
    format_score: float = 0.0,
) -> float:
    answer = extract_gsm8k_answer(solution_str, method)
    if answer is None:
        return 0.0
    return correct_score if _num_eq(answer, ground_truth) else format_score


_BOXED_RE = re.compile(r"\\boxed\{")


def extract_boxed_answer(text: str) -> str | None:
    """Last \\boxed{...} with balanced braces (MATH-style)."""
    starts = [m.end() for m in _BOXED_RE.finditer(text)]
    if not starts:
        return None
    start = starts[-1]
    depth = 1
    for i in range(start, len(text)):
        c = text[i]
        if c == "{":
            depth += 1
        elif c == "}":
            depth -= 1
            if depth == 0:
                return text[start:i]
    return None


def _normalize_math(ans: str) -> str:
    ans = ans.strip()
    ans = ans.replace("\\left", "").replace("\\right", "")
    ans = ans.replace("\\!", "").replace("\\,", "").replace("\\;", "").replace(" ", "")
    ans = ans.replace("\\%", "").replace("%", "")
    ans = ans.replace("\\$", "").replace("$", "")
    ans = re.sub(r"\\text\{[^}]*\}", "", ans)
    ans = re.sub(r"\\mbox\{[^}]*\}", "", ans)
    ans = ans.replace("\\dfrac", "\\frac").replace("\\tfrac", "\\frac")
    ans = ans.rstrip(".")
    # \frac{a}{b} → a/b for simple numeric fractions
    m = re.fullmatch(r"\\frac\{(-?\d+)\}\{(-?\d+)\}", ans)
    if m:
        ans = f"{m.group(1)}/{m.group(2)}"
    if ans.endswith("\\"):
        ans = ans[:-1]
    return ans


def compute_score_math(solution_str: str, ground_truth: str) -> float:
    answer = extract_boxed_answer(solution_str)
    if answer is None:
        return 0.0
    a, b = _normalize_math(answer), _normalize_math(ground_truth)
    if a == b or _num_eq(a, b):
        return 1.0
    # numeric fraction equivalence
    def to_float(s: str) -> float | None:
        m = re.fullmatch(r"(-?\d+(?:\.\d+)?)/(-?\d+(?:\.\d+)?)", s)
        if m:
            try:
                return float(m.group(1)) / float(m.group(2))
            except ZeroDivisionError:
                return None
        try:
            return float(s)
        except ValueError:
            return None
    fa, fb = to_float(a), to_float(b)
    if fa is not None and fb is not None:
        return 1.0 if abs(fa - fb) < 1e-6 else 0.0
    return 0.0


_GEO3K_FORMAT_RE = re.compile(r"<think>.*</think>.*\\boxed\{.*\}.*",
                              re.DOTALL)


def compute_score_geo3k(solution_str: str, ground_truth: str) -> float:
    """Geometry3k (reference dispatch row reward_score/__init__.py:92-95 →
    verl's geo3k scorer): 0.9 × boxed-answer accuracy + 0.1 × format reward
    (a full ``<think>…</think> … \\boxed{}`` trace). The accuracy half
    reuses the boxed-math equivalence grader; the multimodal (image) input
    side rides the normal prompt path — scoring is text-only, as in the
    reference."""
    acc = compute_score_math(solution_str, ground_truth)
    fmt = 1.0 if _GEO3K_FORMAT_RE.fullmatch(solution_str) else 0.0
    return 0.9 * acc + 0.1 * fmt


def compute_score_math_dapo(
    solution_str: str,
    ground_truth: str,
    correct_score: float = 1.0,
    incorrect_score: float = -1.0,
) -> float:
    """DAPO/AIME-style strict scoring: the answer must appear in a
    ``\\boxed{}``; correct → +1, anything else → −1 (the reference's
    math_dapo scorer's ±1 scheme, reward_score/__init__.py dispatch row
    math_dapo/aime)."""
    answer = extract_boxed_answer(solution_str)
    if answer is None:
        return incorrect_score
    ok = compute_score_math(f"\\boxed{{{answer}}}", ground_truth) > 0.0
    return correct_score if ok else incorrect_score


_ANSWER_PATTERNS = (
    re.compile(r"(?:final answer|answer)\s*(?:is|:)\s*([^\n.,;]+)", re.IGNORECASE),
)


def compute_score_prime_math(solution_str: str, ground_truth: str) -> float:
    """Robust math equivalence with fallback extraction (the reference's
    numina → prime_math route): boxed first, then 'answer is X' phrasing,
    then last number."""
    if compute_score_math(solution_str, ground_truth) > 0.0:
        return 1.0
    gt = _normalize_math(ground_truth)
    for pat in _ANSWER_PATTERNS:
        matches = pat.findall(solution_str)
        if matches and (_normalize_math(matches[-1]) == gt
                        or _num_eq(_normalize_math(matches[-1]), gt)):
            return 1.0
    last = extract_gsm8k_answer(solution_str, method="flexible")
    if last is not None and _num_eq(last, gt):
        return 1.0
    return 0.0


# -- code execution (local sandbox) -----------------------------------------

_CODE_BLOCK_RE = re.compile(r"```(?:python|py)?\s*\n(.*?)```", re.DOTALL)


def extract_code(solution_str: str) -> str | None:
    """Last fenced code block, else None."""
    blocks = _CODE_BLOCK_RE.findall(solution_str)
    return blocks[-1].strip() if blocks else None


def _run_sandboxed(code: str, stdin: str, timeout_s: float) -> tuple[bool, str]:
    """Run model-emitted code in an isolated python subprocess with CPU and
    memory rlimits — the local stand-in for the reference's sandbox-fusion
    code-execution service (reward.py:95-150)."""
    import resource
    import subprocess
    import sys

    def limits():
        resource.setrlimit(resource.RLIMIT_CPU, (int(timeout_s) + 1,) * 2)
        resource.setrlimit(resource.RLIMIT_AS, (1 << 30,) * 2)
        resource.setrlimit(resource.RLIMIT_NPROC, (64, 64))

    try:
        proc = subprocess.run(
            [sys.executable, "-I", "-c", code], input=stdin,
            capture_output=True, text=True, timeout=timeout_s,
            preexec_fn=limits)
    except subprocess.TimeoutExpired:
        return False, "timeout"
    except Exception as exc:  # noqa: BLE001
        return False, str(exc)
    if proc.returncode != 0:
        return False, proc.stderr[-500:]
    return True, proc.stdout


def compute_score_code(
    solution_str: str,
    ground_truth: str,
    extra_info: dict | None = None,
    timeout_s: float = 6.0,
    run_fn=None,
) -> float:
    """Code-contest scoring: fraction of test cases passed (the reference's
    prime_code / sandbox path for codecontests/apps/codeforces/taco).

    Test cases come from ``extra_info`` (or JSON-decoded ``ground_truth``):
    ``{"inputs": [...], "outputs": [...]}`` stdin/stdout pairs, or
    ``{"asserts": "..."}`` appended to the program.

    ``run_fn(code, stdin, timeout_s) -> (ok, stdout)`` selects the execution
    backend: default is the local rlimit'd subprocess; the remote
    sandbox-service client (rewards/sandbox.py) plugs in here for pod-scale
    scoring.
    """
    if run_fn is None:
        run_fn = _run_sandboxed
    code = extract_code(solution_str)
    if code is None:
        return 0.0
    tests = None
    if extra_info and isinstance(extra_info.get("test_cases"), dict):
        tests = extra_info["test_cases"]
    else:
        import json as _json

        try:
            parsed = _json.loads(ground_truth)
            if isinstance(parsed, dict):
                tests = parsed
        except (ValueError, TypeError):
            tests = None
    if not tests:
        return 0.0
    if "asserts" in tests:
        ok, _ = run_fn(code + "\n\n" + tests["asserts"], "", timeout_s)
        return 1.0 if ok else 0.0
    inputs = tests.get("inputs", [])
    outputs = tests.get("outputs", [])
    if not inputs:
        return 0.0
    passed = 0
    for stdin, expect in zip(inputs, outputs):
        ok, out = run_fn(code, str(stdin), timeout_s)
        if ok and out.strip() == str(expect).strip():
            passed += 1
    return passed / len(inputs)


# -- QA exact match ---------------------------------------------------------

_ARTICLES_RE = re.compile(r"\b(a|an|the)\b")
_PUNCT_RE = re.compile(r"[^\w\s]")


def _normalize_qa(text: str) -> str:
    text = text.lower()
    text = _PUNCT_RE.sub(" ", text)
    text = _ARTICLES_RE.sub(" ", text)
    return " ".join(text.split())


def compute_score_qa_em(
    solution_str: str,
    ground_truth: str,
    extra_info: dict | None = None,
) -> float:
    """SearchR1-style QA exact match (reference searchR1 QA-EM row):
    normalized answer (inside <answer></answer> tags when present, else the
    full response tail) must equal one of the gold answers
    ('|||'-separated)."""
    m = re.findall(r"<answer>(.*?)</answer>", solution_str, re.DOTALL)
    cand = m[-1] if m else solution_str
    cand_n = _normalize_qa(cand)
    golds = [g for g in (ground_truth or "").split("|||")]
    for g in golds:
        gn = _normalize_qa(g)
        if gn and (cand_n == gn or (m and gn in cand_n)):
            return 1.0
    return 0.0


def default_compute_score(
    data_source: str,
    solution_str: str,
    ground_truth: str,
    extra_info: dict | None = None,
    run_fn=None,
) -> float:
    """Per-dataset dispatch (reference reward_score/__init__.py:19-117).
    ``run_fn`` overrides the code-execution backend (rewards/sandbox.py)."""
    ds = (data_source or "").lower()
    if "gsm8k" in ds:
        return compute_score_gsm8k(solution_str, ground_truth)
    if any(k in ds for k in ("math_dapo", "aime", "dapo")):
        return compute_score_math_dapo(solution_str, ground_truth)
    if any(k in ds for k in ("numina", "prime_math")):
        return compute_score_prime_math(solution_str, ground_truth)
    if any(k in ds for k in ("geometry3k", "geo3k")):
        return compute_score_geo3k(solution_str, ground_truth)
    if any(k in ds for k in ("math", "openr1", "deepscaler")):
        return compute_score_math(solution_str, ground_truth)
    if any(k in ds for k in ("code", "apps", "taco", "codeforces")):
        return compute_score_code(solution_str, ground_truth, extra_info,
                                  run_fn=run_fn)
    if any(k in ds for k in ("searchr1", "nq", "triviaqa", "hotpotqa", "qa_em")):
        return compute_score_qa_em(solution_str, ground_truth, extra_info)
    # default: MATH-style then gsm8k-style
    score = compute_score_math(solution_str, ground_truth)
    if score == 0.0:
        score = compute_score_gsm8k(solution_str, ground_truth)
    return score
