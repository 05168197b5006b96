"""Synthetic MIND-format corpus generator for tests and offline benchmarks.

Writes news.tsv / behaviors.tsv files in the exact MIND column layout the
readers expect (news: 8 cols, behaviors: 5 cols), with a click model that
gives the models real signal to learn: each user has a latent topic
preference and clicks news from preferred categories more often, so training
should push AUC well above 0.5 on held-out impressions.
"""

from __future__ import annotations

import os

import numpy as np

_WORDS_PER_TOPIC = 50


def generate_corpus(out_dir: str, num_news: int = 200, num_users: int = 100,
                    num_impressions: int = 500, num_topics: int = 5,
                    title_len: int = 8, max_history: int = 30,
                    candidates_per_impression: int = 10, seed: int = 0,
                    split: str = "train") -> None:
    """Write {out_dir}/news.tsv and {out_dir}/behaviors.tsv."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)

    topics = [f"cat{t}" for t in range(num_topics)]
    news_topic = rng.integers(0, num_topics, size=num_news)
    doc_ids = [f"N{i + 1}" for i in range(num_news)]

    with open(os.path.join(out_dir, "news.tsv"), "w", encoding="utf-8") as f:
        for i, doc in enumerate(doc_ids):
            t = news_topic[i]
            # topic-specific word pool makes titles informative about topic
            words = [
                f"w{t * _WORDS_PER_TOPIC + w}"
                for w in rng.integers(0, _WORDS_PER_TOPIC, size=title_len)
            ]
            title = " ".join(words)
            cat = topics[t]
            subcat = f"{cat}_sub{rng.integers(0, 3)}"
            f.write("\t".join([doc, cat, subcat, title, "abstract text",
                               "http://x", "", ""]) + "\n")

    user_pref = rng.integers(0, num_topics, size=num_users)

    def click_prob(user: int, news: int) -> float:
        return 0.8 if news_topic[news] == user_pref[user] else 0.1

    with open(os.path.join(out_dir, "behaviors.tsv"), "w", encoding="utf-8") as f:
        for imp in range(num_impressions):
            u = int(rng.integers(0, num_users))
            hist_len = int(rng.integers(1, max_history + 1))
            # history biased toward the user's preferred topic
            hist = []
            while len(hist) < hist_len:
                n = int(rng.integers(0, num_news))
                if rng.random() < click_prob(u, n):
                    hist.append(doc_ids[n])
            cand = rng.choice(num_news, size=candidates_per_impression,
                              replace=False)
            labels = [int(rng.random() < click_prob(u, int(n))) for n in cand]
            if not any(labels):
                labels[int(rng.integers(0, len(labels)))] = 1
            if all(labels):
                labels[int(rng.integers(0, len(labels)))] = 0
            imp_str = " ".join(
                f"{doc_ids[int(n)]}-{l}" for n, l in zip(cand, labels)
            )
            f.write("\t".join([
                str(imp + 1), f"U{u + 1}",
                "11/11/2019 11:11:11 AM", " ".join(hist), imp_str,
            ]) + "\n")
