"""ProxyQ pseudo-query generator: N grounded questions per page image.

The torch port's copy of ``evdr_tpu/tools/make_questions.py`` (stdlib
only; the ``openai`` backend imports its package when it runs). Console script: ``evdr-makeq-torch``.

Functional parity with reference ``makeQ.py``: walks a directory of page
jpgs, asks a vision LLM (default gpt-4o-mini via the OpenAI API) for exactly
``--nq`` non-redundant questions answerable from the page, parses the
numbered list, retries per image, checkpoints the output JSON periodically,
and resumes by image_path. Output schema matches ``ProxyQ/*.json``:
``{id: {"image_path": ..., "Question": [...]}}``.

Additions over the reference:
- ``--backend fake`` generates deterministic placeholder questions without
  network access (pipeline testing in air-gapped environments);
- failed images are recorded with an ``"error"`` field AND retried on resume
  (the reference skips any id present in the output, including failures).
"""

from __future__ import annotations

import argparse
import base64
import json
import re
import time
from pathlib import Path
from typing import Dict, List, Optional

SYSTEM_PROMPT = (
    "You generate retrieval-evaluation questions for document page images. "
    "Every question must be answerable using only the given page."
)

RULES_PROMPT = """Look at this document page image and write exactly {nq} questions.
Rules:
1. Each question must be answerable from THIS page alone.
2. No two questions may be redundant or trivial rephrasings.
3. Cover different regions/aspects of the page (titles, tables, figures, numbers, text).
4. Questions must be self-contained (no "this page"/"the image" phrasing).
5. Output ONLY a numbered list: "1. ...", "2. ...", one question per line."""

_NUM_RE = re.compile(r"^\s*(\d+)[.)]\s*(.+?)\s*$")


def parse_numbered_questions(text: str, nq: int) -> List[str]:
    """Parse a numbered list; tolerates prose around it (reference makeQ.py:18-41)."""
    out: List[str] = []
    for line in text.splitlines():
        m = _NUM_RE.match(line)
        if m:
            q = m.group(2).strip().strip('"')
            if q:
                out.append(q)
    return out[:nq]


def _b64_data_url(image_path: Path) -> str:
    data = base64.b64encode(image_path.read_bytes()).decode("ascii")
    suffix = image_path.suffix.lstrip(".").lower() or "jpeg"
    if suffix == "jpg":
        suffix = "jpeg"
    return f"data:image/{suffix};base64,{data}"


def _gen_openai(image_path: Path, nq: int, model: str) -> List[str]:
    from openai import OpenAI  # gated: requires the openai package + API key

    client = OpenAI()
    resp = client.responses.create(
        model=model,
        input=[
            {"role": "system", "content": SYSTEM_PROMPT},
            {"role": "user", "content": [
                {"type": "input_text", "text": RULES_PROMPT.format(nq=nq)},
                {"type": "input_image", "image_url": _b64_data_url(image_path)},
            ]},
        ],
    )
    return parse_numbered_questions(resp.output_text, nq)


def _gen_fake(image_path: Path, nq: int) -> List[str]:
    stem = image_path.stem
    return [f"placeholder question {i + 1} about page {stem}" for i in range(nq)]


def generate_questions(
    image_dir,
    out_json,
    nq: int = 50,
    model: str = "gpt-4o-mini",
    backend: str = "openai",
    retries: int = 3,
    save_every: int = 10,
    resume: bool = True,
    patterns=("*.jpg", "*.jpeg", "*.png"),
) -> Dict:
    image_dir = Path(image_dir)
    out_json = Path(out_json)
    images = sorted(p for pat in patterns for p in image_dir.glob(pat))
    if not images:
        raise FileNotFoundError(f"no page images under {image_dir}")

    results: Dict[str, Dict] = {}
    if resume and out_json.exists():
        results = json.loads(out_json.read_text(encoding="utf-8"))

    done_paths = {
        v.get("image_path") for v in results.values()
        if v.get("Question") and not v.get("error")
    }

    def save():
        out_json.parent.mkdir(parents=True, exist_ok=True)
        out_json.write_text(json.dumps(results, ensure_ascii=False, indent=1),
                            encoding="utf-8")

    n_new = 0
    for img in images:
        key = img.stem
        if str(img) in done_paths:
            continue
        if key in results and results[key].get("image_path") != str(img):
            # page1.jpg vs page1.png: a bare stem would overwrite the other
            # image's (paid) questions — disambiguate with the extension
            key = img.name
        questions, err = [], None
        for attempt in range(retries):
            try:
                if backend == "fake":
                    questions = _gen_fake(img, nq)
                else:
                    questions = _gen_openai(img, nq, model)
                if len(questions) == nq:
                    break
                err = f"got {len(questions)}/{nq} questions"
            except Exception as e:  # noqa: BLE001 — record + retry
                err = str(e)
                time.sleep(min(2 ** attempt, 8))
        entry = {"image_path": str(img), "Question": questions}
        if len(questions) != nq:
            entry["error"] = err or "incomplete"
        results[key] = entry
        n_new += 1
        if n_new % save_every == 0:
            save()
    save()
    return results


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--image_dir", required=True)
    p.add_argument("--out_json", required=True)
    p.add_argument("--nq", type=int, default=50)
    p.add_argument("--model", default="gpt-4o-mini")
    p.add_argument("--backend", choices=("openai", "fake"), default="openai")
    p.add_argument("--retries", type=int, default=3)
    p.add_argument("--save_every", type=int, default=10)
    p.add_argument("--no_resume", action="store_true")
    a = p.parse_args(argv)
    results = generate_questions(
        a.image_dir, a.out_json, nq=a.nq, model=a.model, backend=a.backend,
        retries=a.retries, save_every=a.save_every, resume=not a.no_resume)
    ok = sum(1 for v in results.values() if not v.get("error"))
    print(f"[makeQ] {ok}/{len(results)} pages complete -> {a.out_json}")


if __name__ == "__main__":
    main()
