from .scores import (  # noqa: F401
    ACC3, ACC7, accuracy_score, classification_report_dict,
    f1_score_weighted, format_classification_report, mcnemar_test,
    misa_report, multiclass_acc, pearson_corr, test_ce_score, test_mse_score,
)
