"""Shared evaluation metrics (pure functions, no datasets or model needed):
a copy of moondream_tpu/eval/metrics.py, kept so that the port imports
nothing of the JAX package; tests/test_torch_host.py holds it to the
original, function by function.

Semantics match the upstream moondream eval harness:
  * VQAScorer — canonical VQAEval normalization (upstream eval/utils.py)
  * relaxed_correctness — ChartQA ±5% numeric tolerance, pix2struct port
    (upstream eval/chartqa.py)
  * anls — DocVQA normalized Levenshtein similarity (upstream eval/docvqa.py)
  * box IoU / 11-point AP — COCO mAP@0.5 (upstream eval/coco_map.py)
  * greedy_match — confidence-free P/R/F1 matching
    (upstream eval/waste_detection.py)
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import numpy as np

Box = Tuple[float, float, float, float]

_CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't", "couldve": "could've",
    "couldnt": "couldn't", "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
    "didnt": "didn't", "doesnt": "doesn't", "dont": "don't", "hadnt": "hadn't",
    "hadnt've": "hadn't've", "hadn'tve": "hadn't've", "hasnt": "hasn't",
    "havent": "haven't", "hed": "he'd", "hed've": "he'd've", "he'dve": "he'd've",
    "hes": "he's", "howd": "how'd", "howll": "how'll", "hows": "how's",
    "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
    "isnt": "isn't", "itd": "it'd", "itd've": "it'd've", "it'dve": "it'd've",
    "itll": "it'll", "let's": "let's", "maam": "ma'am", "mightnt": "mightn't",
    "mightnt've": "mightn't've", "mightn'tve": "mightn't've", "mightve": "might've",
    "mustnt": "mustn't", "mustve": "must've", "neednt": "needn't",
    "notve": "not've", "oclock": "o'clock", "oughtnt": "oughtn't",
    "ow's'at": "'ow's'at", "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at",
    "shant": "shan't", "shed've": "she'd've", "she'dve": "she'd've",
    "she's": "she's", "shouldve": "should've", "shouldnt": "shouldn't",
    "shouldnt've": "shouldn't've", "shouldn'tve": "shouldn't've",
    "somebody'd": "somebodyd", "somebodyd've": "somebody'd've",
    "somebody'dve": "somebody'd've", "somebodyll": "somebody'll",
    "somebodys": "somebody's", "someoned": "someone'd",
    "someoned've": "someone'd've", "someone'dve": "someone'd've",
    "someonell": "someone'll", "someones": "someone's", "somethingd": "something'd",
    "somethingd've": "something'd've", "something'dve": "something'd've",
    "somethingll": "something'll", "thats": "that's", "thered": "there'd",
    "thered've": "there'd've", "there'dve": "there'd've", "therere": "there're",
    "theres": "there's", "theyd": "they'd", "theyd've": "they'd've",
    "they'dve": "they'd've", "theyll": "they'll", "theyre": "they're",
    "theyve": "they've", "twas": "'twas", "wasnt": "wasn't",
    "wed've": "we'd've", "we'dve": "we'd've", "weve": "we've",
    "werent": "weren't", "whatll": "what'll", "whatre": "what're",
    "whats": "what's", "whatve": "what've", "whens": "when's",
    "whered": "where'd", "wheres": "where's", "whereve": "where've",
    "whod": "who'd", "whod've": "who'd've", "who'dve": "who'd've",
    "wholl": "who'll", "whos": "who's", "whove": "who've", "whyll": "why'll",
    "whyre": "why're", "whys": "why's", "wont": "won't", "wouldve": "would've",
    "wouldnt": "wouldn't", "wouldnt've": "wouldn't've",
    "wouldn'tve": "wouldn't've", "yall": "y'all", "yall'll": "y'all'll",
    "y'allll": "y'all'll", "yall'd've": "y'all'd've", "y'alld've": "y'all'd've",
    "y'all'dve": "y'all'd've", "youd": "you'd", "youd've": "you'd've",
    "you'dve": "you'd've", "youll": "you'll", "youre": "you're", "youve": "you've",
}

_DIGIT_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3", "four": "4",
    "five": "5", "six": "6", "seven": "7", "eight": "8", "nine": "9", "ten": "10",
}

_ARTICLES = ("a", "an", "the")

_PUNCT = [
    ";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\", "_", "-",
    ">", "<", "@", "`", ",", "?", "!",
]

_PERIOD_RE = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_RE = re.compile(r"(\d)(,)(\d)")


class VQAScorer:
    """Canonical VQAEval scoring (reference eval/utils.py:5-256)."""

    def process_punctuation(self, text: str) -> str:
        out = text
        for p in _PUNCT:
            if (p + " " in text or " " + p in text) or (
                _COMMA_RE.search(text) is not None
            ):
                out = out.replace(p, "")
            else:
                out = out.replace(p, " ")
        return _PERIOD_RE.sub("", out, re.UNICODE)

    def process_digit_article(self, text: str) -> str:
        words = []
        for word in text.lower().split():
            word = _DIGIT_MAP.get(word, word)
            if word not in _ARTICLES:
                words.append(word)
        for i, word in enumerate(words):
            if word in _CONTRACTIONS:
                words[i] = _CONTRACTIONS[word]
        return " ".join(words)

    def process_answer(self, answer: str) -> str:
        answer = answer.replace("\n", " ").replace("\t", " ").strip()
        return self.process_digit_article(self.process_punctuation(answer))

    def compute_score(self, candidate: str, gt_answers: List[str]) -> float:
        candidate = self.process_answer(candidate)
        gts = [g.replace("\n", " ").replace("\t", " ").strip() for g in gt_answers]
        if len(set(gts)) > 1:
            candidate = self.process_digit_article(
                self.process_punctuation(candidate)
            )
            gts = [
                self.process_punctuation(self.process_digit_article(g)) for g in gts
            ]
        matching = sum(1 for g in gts if g == candidate)
        return min(1.0, matching / 3.0)


def relaxed_correctness(
    target: str, prediction: str, max_relative_change: float = 0.05
) -> bool:
    """ChartQA relaxed accuracy (reference chartqa.py:16-56)."""

    def to_float(text: str):
        try:
            if text.endswith("%"):
                return float(text.rstrip("%")) / 100.0
            return float(text)
        except ValueError:
            return None

    prediction, target = str(prediction), str(target)
    p, t = to_float(prediction), to_float(target)
    if p is not None and t:
        return abs(p - t) / abs(t) <= max_relative_change
    return prediction == target


def edit_distance(a: str, b: str) -> int:
    """Levenshtein distance (replaces the reference's `editdistance` C dep)."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def anls(s1: str, s2: str) -> float:
    """DocVQA average normalized Levenshtein similarity (docvqa.py:15-20)."""
    s1, s2 = s1.lower().strip(), s2.lower().strip()
    if max(len(s1), len(s2)) == 0:
        return 1.0
    sim = 1 - edit_distance(s1, s2) / max(len(s1), len(s2))
    return sim if sim >= 0.5 else 0.0


def box_iou(a: Box, b: Box) -> float:
    """Corner-format IoU (coco_map.py:116-129 / waste_detection.py:18-25)."""
    x1, y1 = max(a[0], b[0]), max(a[1], b[1])
    x2, y2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / union if union else 0.0


def average_precision(
    gt_boxes: List[Box],
    pred_boxes: List[Tuple[float, float, float, float, float]],
    iou_threshold: float = 0.5,
) -> float:
    """11-point AP for one class/one image group (coco_map.py:132-207).

    pred_boxes carry a trailing confidence and are matched greedily in
    confidence order; each GT matches at most once.
    """
    if not gt_boxes:
        return 0.0
    preds = sorted(pred_boxes, key=lambda x: x[4], reverse=True)
    tp = np.zeros(len(preds))
    fp = np.zeros(len(preds))
    matched = [False] * len(gt_boxes)

    for pi, pred in enumerate(preds):
        best_iou, best_gi = 0.0, -1
        for gi, gt in enumerate(gt_boxes):
            if matched[gi]:
                continue
            i = box_iou(pred[:4], gt)
            if i > best_iou:
                best_iou, best_gi = i, gi
        if best_iou >= iou_threshold:
            tp[pi] = 1
            matched[best_gi] = True
        else:
            fp[pi] = 1

    ctp, cfp = np.cumsum(tp), np.cumsum(fp)
    recalls = ctp / len(gt_boxes)
    precisions = ctp / np.maximum(ctp + cfp, 1e-12)

    ap = 0.0
    for t in np.arange(0, 1.1, 0.1):
        mask = recalls >= t
        ap += (np.max(precisions[mask]) if mask.any() else 0.0) / 11
    return float(ap)


def aggregate_map(
    results_by_label: Dict[int, List[float]], frequency_by_label: Dict[int, int]
) -> float:
    """Frequency-weighted aggregation (coco_map.py:210-219)."""
    total_map = sum(sum(v) for v in results_by_label.values())
    total_count = sum(frequency_by_label.values())
    return total_map / total_count if total_count else 0.0


def greedy_match(
    gt: Sequence[Box], pred: Sequence[Box], iou_thr: float
) -> Tuple[int, int, int]:
    """Confidence-free greedy one-to-one matching -> (tp, fp, fn)
    (waste_detection.py:28-51)."""
    tp = fp = 0
    seen = [False] * len(gt)
    for p in pred:
        best, best_i = 0.0, -1
        for i, g in enumerate(gt):
            if seen[i]:
                continue
            v = box_iou(p, g)
            if v > best:
                best, best_i = v, i
        if best >= iou_thr:
            tp += 1
            seen[best_i] = True
        else:
            fp += 1
    return tp, fp, len(gt) - tp


def precision_recall_f1(tp: int, fp: int, fn: int) -> Dict[str, float]:
    prec = tp / (tp + fp) if tp + fp else 0.0
    rec = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
    return {"precision": prec, "recall": rec, "f1": f1}
