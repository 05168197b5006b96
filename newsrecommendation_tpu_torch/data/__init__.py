from newsrecommendation_tpu_torch.data.mind import (  # noqa: F401
    NewsCorpus,
    build_news_features,
    random_word_embeddings,
    read_news,
    tokenize,
)
