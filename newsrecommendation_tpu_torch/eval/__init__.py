from newsrecommendation_tpu_torch.eval.pipeline import (  # noqa: F401
    combine_metric_sums,
    compute_news_scoring,
    cross_process_sum,
    doc_sim_probe,
    evaluate_impressions,
    make_eval_multi_step_acc,
    make_eval_step,
    make_eval_step_acc,
    summarize_metric_sums,
)
