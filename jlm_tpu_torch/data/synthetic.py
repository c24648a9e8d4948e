"""Deterministic synthetic Japanese corpus for tests and benchmarks.

The port's copy of :mod:`jlm_tpu.data.synthetic`.

The reference trains on BCCWJ, which cannot ship with this repo
(SURVEY.md §4.1), so CI and the benchmark harness use a small built-in
lexicon with genuine homophone ambiguity (きょう → 今日/京, はし → 橋/箸/端,
かみ → 神/紙/髪, …) and a seeded template generator.  The generated
corpus + fixed test-sentence file play the role of the reference's
"fixed Japanese test-sentence file" in BASELINE config 1.

Everything is a pure function of the seed, so golden parity outputs are
stable from run to run without checking binary data into git.
"""

from __future__ import annotations

import random
from typing import List, Tuple

# (display, reading, POS).  Homophone groups are deliberate: they create
# multi-candidate lattice nodes that exercise beam pruning and tie-breaking.
SYNTH_WORDS: List[Tuple[str, str, str]] = [
    # --- nouns, with homophone clusters ---
    ("今日", "きょう", "名詞"), ("京", "きょう", "名詞"), ("経", "きょう", "名詞"),
    ("明日", "あした", "名詞"), ("朝", "あさ", "名詞"), ("麻", "あさ", "名詞"),
    ("橋", "はし", "名詞"), ("箸", "はし", "名詞"), ("端", "はし", "名詞"),
    ("神", "かみ", "名詞"), ("紙", "かみ", "名詞"), ("髪", "かみ", "名詞"),
    ("雨", "あめ", "名詞"), ("飴", "あめ", "名詞"),
    ("花", "はな", "名詞"), ("鼻", "はな", "名詞"),
    ("天気", "てんき", "名詞"), ("電気", "でんき", "名詞"),
    ("海", "うみ", "名詞"), ("膿", "うみ", "名詞"),
    ("空", "そら", "名詞"), ("街", "まち", "名詞"), ("町", "まち", "名詞"),
    ("人", "ひと", "名詞"), ("火", "ひ", "名詞"), ("日", "ひ", "名詞"),
    ("木", "き", "名詞"), ("気", "き", "名詞"),
    ("目", "め", "名詞"), ("芽", "め", "名詞"),
    ("手", "て", "名詞"), ("家", "いえ", "名詞"),
    ("犬", "いぬ", "名詞"), ("猫", "ねこ", "名詞"), ("鳥", "とり", "名詞"),
    ("水", "みず", "名詞"), ("山", "やま", "名詞"), ("川", "かわ", "名詞"),
    ("皮", "かわ", "名詞"), ("本", "ほん", "名詞"), ("学校", "がっこう", "名詞"),
    ("先生", "せんせい", "名詞"), ("学生", "がくせい", "名詞"),
    ("会社", "かいしゃ", "名詞"), ("電車", "でんしゃ", "名詞"),
    ("車", "くるま", "名詞"), ("道", "みち", "名詞"), ("未知", "みち", "名詞"),
    ("友達", "ともだち", "名詞"), ("時間", "じかん", "名詞"),
    ("仕事", "しごと", "名詞"), ("言葉", "ことば", "名詞"),
    ("音楽", "おんがく", "名詞"), ("映画", "えいが", "名詞"),
    ("世界", "せかい", "名詞"), ("日本", "にほん", "名詞"),
    ("東京", "とうきょう", "名詞"), ("朝日", "あさひ", "名詞"),
    ("夜", "よる", "名詞"), ("昼", "ひる", "名詞"), ("冬", "ふゆ", "名詞"),
    ("夏", "なつ", "名詞"), ("春", "はる", "名詞"), ("秋", "あき", "名詞"),
    ("空き", "あき", "名詞"), ("飯", "めし", "名詞"),
    ("公園", "こうえん", "名詞"), ("講演", "こうえん", "名詞"),
    ("医者", "いしゃ", "名詞"), ("石", "いし", "名詞"), ("意思", "いし", "名詞"),
    # --- verbs ---
    ("行く", "いく", "動詞"), ("来る", "くる", "動詞"), ("見る", "みる", "動詞"),
    ("食べる", "たべる", "動詞"), ("飲む", "のむ", "動詞"),
    ("読む", "よむ", "動詞"), ("書く", "かく", "動詞"), ("描く", "かく", "動詞"),
    ("聞く", "きく", "動詞"), ("効く", "きく", "動詞"),
    ("話す", "はなす", "動詞"), ("放す", "はなす", "動詞"),
    ("買う", "かう", "動詞"), ("飼う", "かう", "動詞"),
    ("作る", "つくる", "動詞"), ("帰る", "かえる", "動詞"),
    ("蛙", "かえる", "名詞"), ("変える", "かえる", "動詞"),
    ("降る", "ふる", "動詞"), ("振る", "ふる", "動詞"),
    ("会う", "あう", "動詞"), ("合う", "あう", "動詞"),
    ("走る", "はしる", "動詞"), ("歩く", "あるく", "動詞"),
    ("待つ", "まつ", "動詞"), ("松", "まつ", "名詞"),
    ("思う", "おもう", "動詞"), ("使う", "つかう", "動詞"),
    ("です", "です", "助動詞"), ("ます", "ます", "助動詞"),
    ("だ", "だ", "助動詞"), ("した", "した", "動詞"), ("下", "した", "名詞"),
    ("する", "する", "動詞"), ("ある", "ある", "動詞"), ("いる", "いる", "動詞"),
    ("なる", "なる", "動詞"), ("鳴る", "なる", "動詞"),
    # --- adjectives ---
    ("いい", "いい", "形容詞"), ("良い", "よい", "形容詞"),
    ("暑い", "あつい", "形容詞"), ("熱い", "あつい", "形容詞"), ("厚い", "あつい", "形容詞"),
    ("寒い", "さむい", "形容詞"), ("早い", "はやい", "形容詞"), ("速い", "はやい", "形容詞"),
    ("高い", "たかい", "形容詞"), ("安い", "やすい", "形容詞"),
    ("新しい", "あたらしい", "形容詞"), ("白い", "しろい", "形容詞"),
    ("赤い", "あかい", "形容詞"), ("青い", "あおい", "形容詞"),
    ("大きい", "おおきい", "形容詞"), ("小さい", "ちいさい", "形容詞"),
    # --- particles / function words (high frequency) ---
    ("は", "は", "助詞"), ("が", "が", "助詞"), ("を", "を", "助詞"),
    ("に", "に", "助詞"), ("で", "で", "助詞"), ("と", "と", "助詞"),
    ("の", "の", "助詞"), ("も", "も", "助詞"), ("へ", "へ", "助詞"),
    ("から", "から", "助詞"), ("まで", "まで", "助詞"), ("よ", "よ", "助詞"),
    ("ね", "ね", "助詞"), ("か", "か", "助詞"),
    # --- adverbs etc. ---
    ("とても", "とても", "副詞"), ("少し", "すこし", "副詞"),
    ("もう", "もう", "副詞"), ("まだ", "まだ", "副詞"),
    ("今", "いま", "名詞"), ("居間", "いま", "名詞"),
]

_NOUNS = [w for w in SYNTH_WORDS if w[2] == "名詞"]
_VERBS = [w for w in SYNTH_WORDS if w[2] in ("動詞", "助動詞")]
_ADJS = [w for w in SYNTH_WORDS if w[2] == "形容詞"]
_PARTS = [w for w in SYNTH_WORDS if w[2] == "助詞"]
_ADVS = [w for w in SYNTH_WORDS if w[2] == "副詞"]

# Sentence templates as sequences of POS pools.  Zipf-ish word choice within
# a pool gives the frequency-ordered vocab a realistic long tail.
_TEMPLATES = [
    [_NOUNS, _PARTS, _ADJS, _VERBS],
    [_NOUNS, _PARTS, _NOUNS, _PARTS, _VERBS],
    [_ADVS, _NOUNS, _PARTS, _VERBS],
    [_NOUNS, _PARTS, _NOUNS, _PARTS, _NOUNS, _PARTS, _VERBS],
    [_NOUNS, _PARTS, _VERBS, _VERBS],
    [_NOUNS, _PARTS, _ADVS, _ADJS, _VERBS, _PARTS],
]


def _zipf_choice(rng: random.Random, pool):
    """Pick from ``pool`` with a Zipf-like bias toward early entries."""
    n = len(pool)
    # inverse-rank weights
    r = rng.random()
    idx = int(n * (r ** 2.2))  # power law: small indices much more likely
    return pool[min(idx, n - 1)]


def generate_corpus(n_sentences: int = 4000, seed: int = 1234) -> List[str]:
    """Corpus lines of ``display/reading/POS`` tokens (SURVEY.md §4.1)."""
    rng = random.Random(seed)
    lines = []
    for _ in range(n_sentences):
        tpl = rng.choice(_TEMPLATES)
        toks = [_zipf_choice(rng, pool) for pool in tpl]
        lines.append(" ".join(f"{d}/{r}/{p}" for d, r, p in toks))
    return lines


def generate_test_set(
    n_sentences: int = 50, seed: int = 777
) -> List[Tuple[str, str]]:
    """Fixed evaluation set: (kana reading string, gold display string).

    Plays the role of the reference's fixed Japanese test-sentence file
    (BASELINE config 1).  The kana string is the concatenation of token
    readings; gold is the concatenation of displays.
    """
    rng = random.Random(seed)
    out = []
    for _ in range(n_sentences):
        tpl = rng.choice(_TEMPLATES)
        toks = [_zipf_choice(rng, pool) for pool in tpl]
        reading = "".join(r for _, r, _ in toks)
        display = "".join(d for d, _, _ in toks)
        out.append((reading, display))
    return out
