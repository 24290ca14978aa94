"""Labels -> decision tree -> design rules (paper §IV)."""
from repro_torch.rules.labels import Labeling, label_times
from repro_torch.rules.pipeline import RuleReport, distill
from repro_torch.rules.rulesets import (Rule, RuleSet, extract_rulesets,
                                        render_rules_table, rules_by_class)
from repro_torch.rules.trees import (DecisionTree, TreeSearchTrace,
                                     algorithm1)

__all__ = ["Labeling", "label_times", "RuleReport", "distill", "Rule",
           "RuleSet", "extract_rulesets", "render_rules_table",
           "rules_by_class", "DecisionTree", "TreeSearchTrace",
           "algorithm1"]
