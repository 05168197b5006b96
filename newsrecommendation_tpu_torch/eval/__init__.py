from newsrecommendation_tpu_torch.eval.pipeline import compute_news_scoring  # noqa: F401
